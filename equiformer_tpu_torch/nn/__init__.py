from .activation import Activation, Gate, gate_for, irreps2gate, normalized_activation
from .dropout import EquivariantDropout, EquivariantScalarsDropout, GraphDropPath
from .attention_utils import heads2vec, heads_irreps, softmax_dropout_combine, vec2heads
from .linear import IrrepsLinear, ScalarMLP, init_parameters
from .norms import EquivariantLayerNorm
from .radial import GaussianRadialBasis, RadialProfile
from .tp_modules import (
    DTPLayer,
    EdgeDegreeEmbedding,
    FCTP,
    FCTPSwishGate,
    NodeEmbedding,
    SeparableFCTP,
)
