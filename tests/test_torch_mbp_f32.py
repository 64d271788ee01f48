"""Float32 MBP over GF(4): the port's plain version
(``ldpc_tpu_torch.ops.mbp``) against the JAX package's
``make_mbp_decoder(..., dtype=float32)`` on the inputs of
``tests/test_torch_mbp.py`` (five codes, eight settings, 200 syndromes at
p=0.08, 12 iterations).

With each library's own exp, log and tanh the two part on lanes: 45 of 200
at most (surface d=5, product-sum, alpha 1, beta 0.5), on 10 of the 40
cases (``tools/jax_contraction_readings.py``). Float32 carries an ulp of those
functions into decisions, and product-sum saturates: the clip to
+-(1 - 1e-8) rounds to +-1 in float32, so a product that reaches +-1 gives
an infinite message in both packages. The tests hold the witness, the
plain version with JAX's exp, log and tanh put in:

- against JAX compiled with XLA's fusion passes off: every output of every
  lane bit for bit (a NaN equal to a NaN);
- against JAX as it compiles by default: decisions, convergence flags and
  iteration counts equal on every lane. Min-sum's posteriors are bit for
  bit. Product-sum's are non-finite where JAX's are; the finite ones differ
  by what one fused loop does to the ulps. XLA fuses exp through the
  message's log into that loop, and it rounds otherwise than the same
  functions called one at a time.

So every difference between the plain version and JAX in float32 comes
from the libraries' exp, log and tanh and from XLA's fusion, not from the
port's arithmetic. Float32 K9' is held against the plain version on the
card (``tests/test_torch_kernels.py``, ``chip_smoke.py``).
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ldpc_tpu.ops import mbp as jmbp
from ldpc_tpu_torch.ops import mbp as tmbp
from test_torch_mbp import CODES, MAX_ITER, SETTINGS, workload

torch.set_num_threads(1)

UNFUSED = {"xla_disable_hlo_passes": "fusion,loop-fusion"}


def _via_jax(fn):
    """``fn`` (a JAX elementwise function) on a CPU tensor, flattened and
    padded to a power of two so that few shapes compile."""
    def call(x):
        flat = x.reshape(-1).numpy()
        size = max(1024, 1 << (flat.size - 1).bit_length())
        padded = np.zeros(size, flat.dtype)
        padded[: flat.size] = flat
        out = np.asarray(fn(jnp.asarray(padded)))[: flat.size]
        return torch.from_numpy(out.copy()).reshape(x.shape)

    return call


def _args(H, method, alpha, beta):
    n = H.shape[1]
    return (np.full((3, n), 0.08 / 3), MAX_ITER, np.full((3, n), alpha), beta, method, 0.625)


@functools.lru_cache(maxsize=None)
def _runs(name, method, alpha, beta):
    """JAX (default and unfused), the plain version and the witness on one
    case, as numpy tuples (decoding, llrs, converged, iterations)."""
    H, syn = workload(name)
    args = _args(H, method, alpha, beta)
    dec = jmbp.make_mbp_decoder(jmbp.compile_gf4(H), *args, dtype=jnp.float32)
    fused = [np.asarray(x) for x in dec(jnp.asarray(syn))]
    compiled = dec.lower(jnp.asarray(syn)).compile(UNFUSED)
    unfused = [np.asarray(x) for x in compiled(jnp.asarray(syn))]

    def port():
        out = tmbp.make_mbp_decoder(tmbp.compile_gf4(H), *args, device="cpu",
                                    dtype=torch.float32)(syn)
        return [x.numpy() for x in out]

    plain = port()
    with pytest.MonkeyPatch().context() as mp:
        for f in ("exp", "log", "tanh"):
            mp.setattr(torch, f, _via_jax(getattr(jnp, f)))
        witness = port()
    return fused, unfused, plain, witness


def _same_lanes(a, b):
    return ~((a[0] != b[0]).any(axis=1) | (a[2] != b[2]) | (a[3] != b[3]))


CASES = [(name, *s) for name in CODES for s in SETTINGS]


@pytest.mark.parametrize("name,method,alpha,beta", CASES)
def test_mbp_f32_witness_is_unfused_jax_bit_for_bit(name, method, alpha, beta):
    """The witness against JAX compiled with XLA's fusion passes off: every
    output of every lane bit for bit."""
    _, unfused, _, witness = _runs(name, method, alpha, beta)
    assert witness[1].dtype == np.float32
    for a, b in zip(witness, unfused):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name,method,alpha,beta", CASES)
def test_mbp_f32_lanes_match_jax(name, method, alpha, beta):
    """The witness against JAX as compiled by default: decisions, flags and
    iteration counts on every lane; posteriors as the module docstring
    states. The plain version's converged lanes reproduce their
    syndromes."""
    fused, _, plain, witness = _runs(name, method, alpha, beta)
    assert _same_lanes(witness, fused).all()
    if method == tmbp.MINIMUM_SUM:
        np.testing.assert_array_equal(witness[1], fused[1])
    else:
        np.testing.assert_array_equal(np.isfinite(witness[1]), np.isfinite(fused[1]))
        np.testing.assert_array_equal(np.isnan(witness[1]), np.isnan(fused[1]))
    H, syn = workload(name)
    conv = plain[2]
    np.testing.assert_array_equal(tmbp.pauli_syndrome(H, plain[0][conv]), syn[conv])
    assert fused[2][3] and plain[2][3]  # the zero syndrome converges in both
