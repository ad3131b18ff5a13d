"""sigkernel_jax: signature kernels in JAX.

A JAX re-design of the signature-kernel method (Salvi et al.,
arXiv:2006.14794): the Goursat PDE
``d^2 k / ds dt = k * d^2 kappa(x_s, y_t) / ds dt`` is solved by an
anti-diagonal wavefront sweep -- a ``lax.scan`` on any platform, a CUDA
kernel on NVIDIA GPUs -- with gradients via a second (adjoint) PDE solve
wrapped in ``jax.custom_vjp``.

Public surface mirrors the reference library (crispitagorico/sigkernel).
"""

__version__ = "0.1.0"

from .kernels import (  # noqa: F401
    StaticKernel,
    LinearKernel,
    RBFKernel,
    RBF_CEXP_Kernel,
    RBF_SQR_Kernel,
    Linear_ID_Kernel,
    RBF_ID_Kernel,
    CEXP,
    cos_exp_kernel,
)
from .sigkernel import (  # noqa: F401
    SigKernel,
    sig_kernel,
    sig_gram,
    sig_gram_lincomb,
    sig_kernel_and_derivatives_gram,
    k_kgrad,
    sig_distance,
    sig_scoring_rule,
    sig_expected_scoring_rule,
    sig_mmd,
)
from .stats import hypothesis_test, sig_chsic, SigCHSIC, c_alpha  # noqa: F401
from .transforms import (  # noqa: F401
    transform,
    normalize,
    AddTime,
    Reversion,
    LeadLag,
    Dyadic,
    PenOff,
    Stroke_Augment,
    Ink_Augment,
    Pen_Augment,
    white,
    brownian,
    truncated_sig_kernel,
)
from . import naive  # noqa: F401
from . import ops  # noqa: F401
from . import utils  # noqa: F401
