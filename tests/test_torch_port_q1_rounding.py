"""Q1's quantize kernel (``htr_vt_torch/csrc/conv_int8.cu:quantize8``) against
JAX's static quantizer (``htr_vt_tpu/ops/quant.py:_quantize_static``).

The kernel does not divide: it multiplies by the rounded reciprocal of the
scale, rounds by adding 1.5 * 2^23 (the code is the low byte of the sum's
bits), and redoes by true division only the values within 3e-5 of a
rounding tie (and NaN). Its float32 arithmetic is replayed here in numpy,
operation by operation, over every bf16 value (the kernel's inputs are bf16,
before or after the BN prologue) at many scales: the codes must be JAX's,
bit for bit, and the division must stay rare.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from htr_vt_tpu.ops import quant as jq

F32 = np.float32
ROUND = F32(12582912.0)  # 1.5 * 2^23
TIE_SLACK = F32(3e-5)


def bf16_values():
    """Every finite bf16 value as float32 (NaN bit patterns left out)."""
    bits = np.arange(1 << 16, dtype=np.uint32) << 16
    x = bits.view(F32)
    return x[~np.isnan(x)]


def kernel_codes(a, sx):
    """The kernel's codes for float32 values ``a`` at scale ``sx``, and the
    share of values that took the true division."""
    with np.errstate(over="ignore"):  # huge values / tiny scales: inf, clamped
        rsx = F32(1) / sx
        y = a * rsx
        yc = np.fmin(np.fmax(y, F32(-127)), F32(127))  # fminf / fmaxf drop a NaN
        r = yc + ROUND
        slow = (np.abs(yc - (r - ROUND)) > F32(0.5) - TIE_SLACK) | np.isnan(y)
        codes = (r.view(np.uint32) & 0xFF).astype(np.uint8).view(np.int8)
        exact = np.clip(np.rint(a / sx), -127, 127).astype(np.int8)
    return np.where(slow, exact, codes), slow.mean()


@pytest.fixture(scope="module")
def jax_codes():
    fn = jax.jit(lambda x, amax: jq._quantize_static(x, amax)[0])
    return lambda x, amax: np.asarray(fn(jnp.asarray(x), jnp.float32(amax)))


@pytest.mark.parametrize("seed", range(4))
def test_quantize_codes_equal_jax_on_every_bf16_value(jax_codes, seed):
    """Abs-maxes from 1e-3 to 1e3 (log-uniform) and round ones: every bf16
    value's code equals JAX's. The division takes under a thousandth of the
    values at the log-uniform scales; at sx = 1 (abs-max 127) every bf16
    half-integer is an exact tie, 0.4% of the grid."""
    rng = np.random.default_rng(seed)
    amaxes = [(a, 1e-3) for a in 10.0 ** rng.uniform(-3, 3, 24)]
    amaxes += [(a, 1e-2) for a in (3.0, 1.0, 127.0, 0.5)]
    x = bf16_values()
    for amax, share in amaxes:
        amax = F32(amax)
        sx = np.maximum(amax, F32(1e-12)) / F32(127)
        got, slow = kernel_codes(x, sx)
        want = jax_codes(x, amax)
        bad = np.flatnonzero(got != want)
        assert bad.size == 0, (amax, x[bad[:5]], got[bad[:5]], want[bad[:5]])
        assert slow < share, (amax, slow)


@pytest.mark.parametrize("amax", [3.0, 0.7071, 41.3])
def test_quantize_codes_at_the_ties(jax_codes, amax):
    """Values a float32 ulp or two either side of every half-integer code
    boundary (a / sx = k + 1/2, |k| <= 127) and the boundaries themselves,
    where only the division decides: JAX's codes, each of them."""
    amax = F32(amax)
    sx = amax / F32(127)
    k = np.arange(-128, 128, dtype=F32) + F32(0.5)
    centre = (k * sx).astype(F32)
    up = np.nextafter(centre, F32(np.inf))
    down = np.nextafter(centre, F32(-np.inf))
    x = np.unique(np.concatenate([centre, up, np.nextafter(up, F32(np.inf)), down,
                                  np.nextafter(down, F32(-np.inf))]))
    got, _ = kernel_codes(x, sx)
    assert np.array_equal(got, jax_codes(x, amax))


def test_quantize_codes_clamp_and_infinities(jax_codes):
    """Past the clamp and at +-inf the code is +-127, as JAX's."""
    x = np.array([np.inf, -np.inf, 1e30, -1e30, 128.4, -128.6, 127.49, -127.51], F32)
    for amax in (F32(127), F32(1)):
        sx = amax / F32(127)
        got, _ = kernel_codes(x, sx)
        assert np.array_equal(got, jax_codes(x, amax))
