"""Matmul-based DFT over (re, im) float32 pairs.

The reference implementation leans on ``numpy.fft`` / Ooura's C FFT
(``/root/reference/sydr/c_functions/fft8g.h``). Here complex values are
carried as (re, im) float32 pairs and the DFT is evaluated with the
*four-step (Bailey) algorithm*: ``N = N1 * N2`` and

    X[N2*k1 + k2] = sum_{n1} W1[n1, k1] * T[k2, n1] *
                    sum_{n2} W2[k2, n2] * x[n1 + N1*n2]

i.e. reshape to ``[N2, N1]``, a column DFT (matmul with ``W2 [N2, N2]``), a
twiddle multiply (``T[k2, n1] = exp(-2j pi k2 n1 / N)``), a row DFT (matmul
with ``W1 [N1, N1]``), and a transpose. Each complex matmul expands to four
real matmuls; for the acquisition workload the DFT is batched over
(doppler x channel x block), so the matrix units run at high occupancy. At
N ~ 10^4 with factors ~100 the matmul DFT costs ~N*(N1+N2) MACs per
transform, ~35x the flops of an ideal FFT. Whether cuFFT (``jnp.fft`` on
complex64) beats it on a GPU is measured by ``chip_smoke.py``.

Plans are precomputed on the host in float64 and shipped as float32 arrays.
Float32 plans run their matmuls at ``Precision.HIGHEST`` (no TF32
rounding of the operands).
"""

from __future__ import annotations

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np


def _balanced_factors(n: int) -> tuple[int, int]:
    """Factor n = n1 * n2 with n1 <= n2 as close to sqrt(n) as possible."""
    best = None
    f = int(math.isqrt(n))
    while f >= 1:
        if n % f == 0:
            best = (f, n // f)
            break
        f -= 1
    if best is None or best[0] == 1 and n > 64:
        raise ValueError(f"N={n} has no useful factorisation (prime?)")
    return best


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class DFTPlan:
    """Precomputed four-step DFT matrices for a fixed length."""

    n: int
    n1: int
    n2: int
    w1_re: jax.Array  # [n1, n1] outer DFT, W1[n1_idx, k1]
    w1_im: jax.Array
    w2_re: jax.Array  # [n2, n2] inner DFT, W2[k2, n2_idx]
    w2_im: jax.Array
    tw_re: jax.Array  # [n2, n1] twiddles T[k2, n1]
    tw_im: jax.Array

    def tree_flatten(self):
        leaves = (self.w1_re, self.w1_im, self.w2_re, self.w2_im,
                  self.tw_re, self.tw_im)
        return leaves, (self.n, self.n1, self.n2)

    @classmethod
    def tree_unflatten(cls, aux, leaves):
        return cls(aux[0], aux[1], aux[2], *leaves)


def make_plan(
    n: int, inverse: bool = False, dtype=np.float32, matmul_dtype=None
) -> DFTPlan:
    """Build a forward (or inverse, 1/N-scaled) DFT plan for length ``n``.

    ``matmul_dtype`` (e.g. ``jnp.bfloat16``) stores the two DFT matrices in a
    reduced precision; :func:`dft` then casts its inputs to match and
    accumulates in float32 (``preferred_element_type``). The twiddles stay
    in ``dtype`` — they are applied elementwise, so narrowing them saves
    nothing and costs accuracy. bf16 inputs round at
    ~2^-9 relative, far below the noise floor of acquisition workloads.
    """
    n1, n2 = _balanced_factors(n)
    sign = 1.0 if inverse else -1.0

    k1 = np.arange(n1)
    w1 = np.exp(sign * 2j * np.pi * np.outer(k1, k1) / n1)  # [n1_idx, k1]
    k2 = np.arange(n2)
    w2 = np.exp(sign * 2j * np.pi * np.outer(k2, k2) / n2)  # [k2, n2_idx]
    tw = np.exp(sign * 2j * np.pi * np.outer(k2, k1) / n)   # [k2, n1]
    if inverse:
        w2 = w2 / n  # fold the 1/N scale into one factor

    w_dtype = dtype if matmul_dtype is None else matmul_dtype
    return DFTPlan(
        n=n, n1=n1, n2=n2,
        w1_re=jnp.asarray(w1.real.astype(dtype)).astype(w_dtype),
        w1_im=jnp.asarray(w1.imag.astype(dtype)).astype(w_dtype),
        w2_re=jnp.asarray(w2.real.astype(dtype)).astype(w_dtype),
        w2_im=jnp.asarray(w2.imag.astype(dtype)).astype(w_dtype),
        tw_re=jnp.asarray(tw.real.astype(dtype)),
        tw_im=jnp.asarray(tw.imag.astype(dtype)),
    )


def dft(xr: jax.Array, xi: jax.Array, plan: DFTPlan, *,
        permuted_out: bool = False):
    """Batched DFT of (re, im) pairs over the last axis.

    Args:
        xr, xi: ``[..., n]`` float32.
        permuted_out: return the four-step result in its natural
            ``[..., k2, k1]`` matrix layout (canonical index is
            ``N2*k1 + k2``) instead of flattening — skips one full-size
            transpose relayout. Use when the caller reduces the output
            elementwise over many transforms (e.g. the PCPS non-coherent
            magnitude accumulation) and can run :func:`unpermute` once on
            the reduced result.
    Returns:
        (Xr, Xi) of shape ``[..., n]`` (or ``[..., n2, n1]`` permuted).
    """
    batch = xr.shape[:-1]
    n1, n2 = plan.n1, plan.n2
    mm_dtype = plan.w1_re.dtype
    ar = xr.reshape(batch + (n2, n1)).astype(mm_dtype)
    ai = xi.reshape(batch + (n2, n1)).astype(mm_dtype)
    mm = functools.partial(jnp.einsum, preferred_element_type=jnp.float32,
                           precision=jax.lax.Precision.HIGHEST)

    # Inner DFT over n2: B = W2 @ A -> [.., n2(k2), n1]
    br = mm("kn,...nm->...km", plan.w2_re, ar) - mm(
        "kn,...nm->...km", plan.w2_im, ai)
    bi = mm("kn,...nm->...km", plan.w2_re, ai) + mm(
        "kn,...nm->...km", plan.w2_im, ar)

    # Twiddle: C = B * T (float32 elementwise)
    cr = (br * plan.tw_re - bi * plan.tw_im).astype(mm_dtype)
    ci = (br * plan.tw_im + bi * plan.tw_re).astype(mm_dtype)

    # Outer DFT over n1: D[k2, k1] = C @ W1
    dr = mm("...kn,nj->...kj", cr, plan.w1_re) - mm(
        "...kn,nj->...kj", ci, plan.w1_im)
    di = mm("...kn,nj->...kj", cr, plan.w1_im) + mm(
        "...kn,nj->...kj", ci, plan.w1_re)

    if permuted_out:
        return dr, di
    # X[N2*k1 + k2]: transpose [k2, k1] -> [k1, k2], flatten.
    xr_out = jnp.swapaxes(dr, -1, -2).reshape(batch + (plan.n,))
    xi_out = jnp.swapaxes(di, -1, -2).reshape(batch + (plan.n,))
    return xr_out, xi_out


def unpermute(x: jax.Array, plan: DFTPlan) -> jax.Array:
    """Flatten a ``permuted_out`` result ``[..., k2, k1]`` to canonical
    ``[..., n]`` order (one transpose; see :func:`dft`)."""
    batch = x.shape[:-2]
    return jnp.swapaxes(x, -1, -2).reshape(batch + (plan.n,))


def idft(xr: jax.Array, xi: jax.Array, plan: DFTPlan, *,
         permuted_out: bool = False):
    """Inverse DFT; ``plan`` must have been built with ``inverse=True``."""
    # The four-step structure is sign-symmetric; reuse dft with the
    # conjugated, scaled plan.
    return dft(xr, xi, plan, permuted_out=permuted_out)


def circular_correlate(xr, xi, kr, ki, fwd: DFTPlan, inv: DFTPlan):
    """IDFT(DFT(x) * K) for a precomputed frequency-domain kernel K.

    With ``K = conj(DFT(c))`` this computes the circular cross-correlation of
    ``x`` against ``c`` (the PCPS inner step).
    """
    fr, fi = dft(xr, xi, fwd)
    pr = fr * kr - fi * ki
    pi = fr * ki + fi * kr
    return idft(pr, pi, inv)
