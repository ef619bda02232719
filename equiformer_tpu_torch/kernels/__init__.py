"""Hand-written CUDA kernels of the port, each beside its plain PyTorch version.

* ``dtp_lin``     — fused depthwise TP + linear heads: forward (K1,
  ``dtp_lin_fwd``) and backward (K2, ``dtp_lin_bwd``) behind one autograd op
* ``dtp_lin_ho``  — the same op for the force models, differentiable to any
  order: K1 forward, the force backward (K5a, ``dtp_lin_bwd3``: dx, dsh and dw
  in one pass), and the single legs of force training's grad-of-grad (K5b,
  ``dtp_lin_leg``: dx or dsh or dw; K5c, ``dtp_lin_legW``: the head weights)
* ``dtp``         — the DTP as the sparse trilinear primitives T and R,
  differentiable to any order (K6-T ``dtp_t``, K6-R ``dtp_r``), and its
  first-order backward in one launch (K6-FB ``dtp_fused_bwd``): the unfused
  route of every DTP call site
* the radial fold of both (K7, ``radial_fold`` plans): the forward with
  ``w = h @ Wr + offset`` built on chip (K7-F, ``dtp_lin_rad_fwd``), its
  first-order backward (K7-B, ``dtp_lin_rad_bwd``: dx, dh, d[Wr; offset],
  dW) and its force backward (K7-B3, ``dtp_lin_rad_bwd3``: dx, dsh, dh)
* ``segment_csr`` — CSR segment sum over dst-sorted edges (K3)
* ``attn_csr``    — fused segment softmax + dropout + weighted sum (K4 forward;
  its backward is torch ops, as in JAX)

A wrapper runs its plain version for CPU tensors and launches its kernel
for CUDA tensors (or raises).  Each wrapper counts its launches in
``<wrapper>.launches``.  Sources are in ``equiformer_tpu_torch/csrc`` and
build at first use (``kernels/_build.py``).
"""

from .attn_csr import attn_combine, attn_combine_fwd, attn_combine_plain, attn_den_plain
from .dtp import (
    TermList,
    dtp_fused_bwd,
    dtp_fused_bwd_plain,
    dtp_r,
    dtp_r_plain,
    dtp_t,
    dtp_t_plain,
)
from .dtp_lin import (
    DTPLinPlan,
    dtp_lin,
    dtp_lin_bwd,
    dtp_lin_bwd_plain,
    dtp_lin_fwd,
    dtp_lin_legW_plain,
    dtp_lin_plain,
    dtp_lin_rad_bwd,
    dtp_lin_rad_bwd_plain,
    dtp_lin_rad_fwd,
    dtp_lin_rad_plain,
)
from .dtp_lin_ho import (
    dtp_lin_bwd3,
    dtp_lin_bwd3_plain,
    dtp_lin_ho,
    dtp_lin_leg,
    dtp_lin_leg_plain,
    dtp_lin_legW,
    dtp_lin_rad_bwd3,
    dtp_lin_rad_bwd3_plain,
)
from .segment_csr import csr_segment_sum, segment_sum_plain

KERNEL_WRAPPERS = {
    "dtp_lin_fwd": dtp_lin_fwd,
    "dtp_lin_bwd": dtp_lin_bwd,
    "dtp_lin_bwd3": dtp_lin_bwd3,
    "dtp_lin_leg": dtp_lin_leg,
    "dtp_lin_legW": dtp_lin_legW,
    "dtp_lin_rad_fwd": dtp_lin_rad_fwd,
    "dtp_lin_rad_bwd": dtp_lin_rad_bwd,
    "dtp_lin_rad_bwd3": dtp_lin_rad_bwd3,
    "dtp_t": dtp_t,
    "dtp_r": dtp_r,
    "dtp_fused_bwd": dtp_fused_bwd,
    "csr_segment_sum": csr_segment_sum,
    "attn_combine": attn_combine,
}


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNEL_WRAPPERS.items()}
