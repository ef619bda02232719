from .irreps import Irrep, Irreps, MulIrrep
from .cg import su2_cg, wigner_3j, wigner_3j_component
from .spherical import spherical_harmonics, spherical_harmonics_for_irreps
from .tensor_product import (
    Instruction,
    TensorProduct,
    depthwise_tp,
    elementwise_multiply,
    fully_connected_instructions,
    fully_connected_tp,
)
