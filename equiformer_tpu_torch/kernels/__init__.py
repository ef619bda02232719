"""Hand-written CUDA kernels of the port, each beside its plain PyTorch version.

* ``dtp_lin``     — fused depthwise TP + linear heads, forward (K1)
* ``segment_csr`` — CSR segment sum over dst-sorted edges (K3)
* ``attn_csr``    — fused segment softmax + weighted sum (K4)

A wrapper runs its plain version for CPU tensors and launches its kernel
for CUDA tensors (or raises).  Each wrapper counts its launches in
``<wrapper>.launches``.  Sources are in ``equiformer_tpu_torch/csrc`` and
build at first use (``kernels/_build.py``).
"""

from .attn_csr import attn_combine, attn_combine_plain
from .dtp_lin import DTPLinPlan, dtp_lin, dtp_lin_plain
from .segment_csr import csr_segment_sum, segment_sum_plain

KERNEL_WRAPPERS = (dtp_lin, csr_segment_sum, attn_combine)


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0
