"""Hand-written CUDA kernels of the port, each beside its plain PyTorch version.

* ``dtp_lin``     — fused depthwise TP + linear heads: forward (K1,
  ``dtp_lin_fwd``) and backward (K2, ``dtp_lin_bwd``) behind one autograd op
* ``segment_csr`` — CSR segment sum over dst-sorted edges (K3)
* ``attn_csr``    — fused segment softmax + dropout + weighted sum (K4 forward;
  its backward is torch ops, as in JAX)

A wrapper runs its plain version for CPU tensors and launches its kernel
for CUDA tensors (or raises).  Each wrapper counts its launches in
``<wrapper>.launches``.  Sources are in ``equiformer_tpu_torch/csrc`` and
build at first use (``kernels/_build.py``).
"""

from .attn_csr import attn_combine, attn_combine_fwd, attn_combine_plain, attn_den_plain
from .dtp_lin import (
    DTPLinPlan,
    dtp_lin,
    dtp_lin_bwd,
    dtp_lin_bwd_plain,
    dtp_lin_fwd,
    dtp_lin_plain,
)
from .segment_csr import csr_segment_sum, segment_sum_plain

KERNEL_WRAPPERS = {
    "dtp_lin_fwd": dtp_lin_fwd,
    "dtp_lin_bwd": dtp_lin_bwd,
    "csr_segment_sum": csr_segment_sum,
    "attn_combine": attn_combine,
}


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNEL_WRAPPERS.items()}
