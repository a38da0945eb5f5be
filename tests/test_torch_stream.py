"""K18a, the blocked copy o = a u (``ops.cuda.stream_kernel``), against
the body of the JAX package's stream-rate probe
(``benchmarks/baseline_configs.py`` ``measured_pallas_bandwidth``: ``u *
jnp.asarray(1.0001, dtype)``) on the CPU, in f32, f64 and bf16, bit for
bit: one rounded product per entry, the scalar rounded to the storage
type first.  And the rate probe's record on the CPU (tiny n; its rate is
no device metric and carries no data-sheet bound there); the wrappers'
kept scalar against a fresh tensor round trip over a seeded sweep; the
copies' refusals.
"""

from __future__ import annotations

import math
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from multigrid_petsc_tpu_torch.ops.cuda import launches
from multigrid_petsc_tpu_torch.ops.cuda import mdma_kernel as mk
from multigrid_petsc_tpu_torch.ops.cuda import pipeline_kernel as plk
from multigrid_petsc_tpu_torch.ops.cuda import stream_kernel as sk
from multigrid_petsc_tpu_torch.ops.cuda.mdma_kernel import compute_dtype

torch.set_num_threads(2)

TYPES = {"float32": (torch.float32, jnp.float32),
         "float64": (torch.float64, jnp.float64),
         "bfloat16": (torch.bfloat16, jnp.bfloat16)}


@pytest.mark.parametrize("name", list(TYPES))
def test_scale_copy_plain_matches_jax_body(name):
    tdt, jdt = TYPES[name]
    rng = np.random.default_rng(17)
    x = rng.standard_normal((37, 129)) * 10.0 ** rng.integers(-3, 4,
                                                              (37, 129))
    u = jnp.asarray(x, jdt)
    want = np.asarray((u * jnp.asarray(1.0001, jdt)).astype(jnp.float64))
    ut = torch.as_tensor(np.array(u.astype(jnp.float64))).to(tdt)
    got = sk.scale_copy_plain(ut, 1.0001)
    assert got.dtype == tdt and got.shape == ut.shape
    np.testing.assert_array_equal(got.double().numpy(), want)
    # The wrapper takes the plain version for a CPU tensor, and counts no
    # launch.
    launches.clear()
    np.testing.assert_array_equal(sk.scale_copy(ut, 1.0001).double().numpy(),
                                  want)
    assert not launches


def test_scale_copy_refuses_other_devices():
    with pytest.raises(ValueError, match="no kernel for device"):
        sk.scale_copy(torch.ones((2, 2), device="meta"), 1.0001)


def test_measured_kernel_bandwidth_record_on_cpu():
    info = sk.measured_kernel_bandwidth(n=32, dtype=torch.float64,
                                        device="cpu", samples=3)
    assert set(info) == {"bytes_per_s", "samples_GBps", "above_spec",
                         "spec_GBps", "clamped_to_spec", "n", "dtype",
                         "bytes_per_launch", "device"}
    assert info["device"] == "cpu" and info["spec_GBps"] is None
    assert info["n"] == 32 and info["dtype"] == "float64"
    assert info["bytes_per_launch"] == 32 * 32 * 2 * 8
    assert len(info["samples_GBps"]) == 3
    assert info["above_spec"] == [False] * 3
    assert not info["clamped_to_spec"]
    assert info["bytes_per_s"] > 0
    assert info["bytes_per_s"] / 1e9 in info["samples_GBps"]


# Values whose rounding to a storage type is a tie, a subnormal, a sign
# of zero or an overflow: f32 ties 1 + 2^-24 (to even: 1) and 1 + 3 2^-24
# (up), bf16 ties 1 + 2^-8 and 1 + 3 2^-8, f32's least subnormal 2^-149,
# the tie 2^-150 between it and 0, 3 2^-150, bf16's subnormal 2^-133,
# f64's 5e-324, and values past f32's and bf16's largest.
SPECIAL = [0.0, -0.0, 1.0 + 2.0 ** -24, 1.0 + 3 * 2.0 ** -24,
           -(1.0 + 2.0 ** -24), 1.0 + 2.0 ** -8, 1.0 + 3 * 2.0 ** -8,
           2.0 ** -149, 2.0 ** -150, 3 * 2.0 ** -150, -(2.0 ** -150),
           2.0 ** -133, 5e-324, -5e-324, 3.4028235677973366e38, 1e39,
           -1e39, 3.3961e38, float("inf"), float("-inf"), 1.0001]


def _bits(x: float) -> bytes:
    return struct.pack(">d", x)


@pytest.mark.parametrize("name", list(TYPES))
@settings(max_examples=300, deadline=None, derandomize=True)
@given(a=st.one_of(st.sampled_from(SPECIAL),
                   st.floats(allow_nan=False, width=64),
                   st.floats(allow_nan=False, width=32)))
def test_scalar_rounding_cached_equals_a_round_trip(name, a):
    """The wrappers' scalar, made once and then kept, is a rounded to the
    storage type as a tensor round trip rounds it, bit for bit (the sign
    of zero included), on its first call and from the cache."""
    tdt = TYPES[name][0]
    want = float(torch.tensor(a, dtype=tdt).to(compute_dtype(tdt)))
    assert _bits(sk._scalar(a, tdt)) == _bits(want)
    assert _bits(sk._scalar(a, tdt)) == _bits(want)


@pytest.mark.parametrize("name", list(TYPES))
def test_scalar_keeps_the_sign_of_zero(name):
    tdt = TYPES[name][0]
    sk._SCALARS.clear()
    assert _bits(sk._scalar(0.0, tdt)) == _bits(0.0)
    assert _bits(sk._scalar(-0.0, tdt)) == _bits(-0.0)
    assert _bits(sk._scalar(0.0, tdt)) == _bits(0.0)
    assert math.isnan(sk._scalar(float("nan"), tdt))


def test_copies_refuse_what_their_kernels_do_not_take():
    """A meta tensor raises in every copy wrapper; the checks a CUDA launch
    runs first (here on CPU tensors) refuse a type the kernels are not
    built for, a non-contiguous input and an output of another shape or
    device."""
    m = torch.ones((4, 4), device="meta")
    for call in (lambda: sk.scale_copy(m, 1.0001),
                 lambda: sk.scale_copy_(m, 1.0001),
                 lambda: plk.staged_copy(m, 1)):
        with pytest.raises(ValueError, match="no kernel for device"):
            call()
    cpu = torch.device("cpu")
    x = torch.ones((6, 4))
    with pytest.raises(TypeError, match="built for"):
        mk._check_cuda(cpu, {"u": (x.half(), x.shape)}, dtypes=sk.DTYPES)
    with pytest.raises(TypeError, match="the other operands"):
        mk._check_cuda(cpu, {"u": (x, x.shape), "out": (x.double(),
                                                          x.shape)},
                       dtypes=sk.DTYPES)
    with pytest.raises(ValueError, match="contiguous"):
        mk._check_cuda(cpu, {"u": (x.t(), (4, 6))}, dtypes=sk.DTYPES)
    with pytest.raises(ValueError, match="shape"):
        mk._check_cuda(cpu, {"u": (x, x.shape), "out": (x, (4, 6))},
                       dtypes=sk.DTYPES)
    with pytest.raises(ValueError, match="expected meta"):
        mk._check_cuda(torch.device("meta"), {"u": (x, x.shape)})
    assert mk._check_cuda(cpu, {"u": (x, [6, 4])}) == torch.float32
    with pytest.raises(TypeError, match="1-element"):
        mk._check_cuda(cpu, {"u": (x, x.shape)},
                       {"a": torch.ones(1, device="meta")})
