"""K18a, the blocked copy o = a u (``ops.cuda.stream_kernel``), against
the body of the JAX package's stream-rate probe
(``benchmarks/baseline_configs.py`` ``measured_pallas_bandwidth``: ``u *
jnp.asarray(1.0001, dtype)``) on the CPU, in f32, f64 and bf16, bit for
bit: one rounded product per entry, the scalar rounded to the storage
type first.  And the rate probe's record on the CPU (tiny n; its rate is
no device metric and carries no data-sheet bound there).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multigrid_petsc_tpu_torch.ops.cuda import launches
from multigrid_petsc_tpu_torch.ops.cuda import stream_kernel as sk

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
