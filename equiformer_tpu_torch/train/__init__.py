from .engine import evaluate
