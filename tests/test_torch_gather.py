"""K7 (kernels/gather.py): the one-hot hi/lo gather's plain version against
tpuray.kernels.gather_pallas.onehot_gather in Pallas interpret mode, on the
CPU, on the three cases of tests/test_gather_pallas.py.

Tolerances: bit-equal for indices in [0, T) (both compute
f32(bf16(x)) + f32(bf16(x - bf16(x))) rounded once in f32). Outside [0, T)
the port returns zero rows. The JAX kernel does so for its zero padding
rows [T, ceil512(T)) and for the negative indices that its chunk slice
wraps into them, [T - ceil512(T), -1] (-1, the miss sentinel, on a table
that is not a multiple of 512 rows); both are compared. Other negative
indices wrap to row idx + ceil512(T) there, and indices >= ceil512(T)
slice outside the table: not compared (ROADMAP.md section 3). Against
table[idx]: the hi/lo split's ~2^-17 relative error, held to 2^-16 of |x|
(plus 2^-140 for the smallest subnormal ulp)."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from tpuray.kernels.gather_pallas import onehot_gather as jax_onehot_gather

from tpuray_torch.kernels import gather

torch.set_num_threads(2)


def _case(name):
    if name == "uniform":
        rng = np.random.default_rng(0)
        table = rng.uniform(-8, 8, (1000, 26)).astype(np.float32)
        idx = rng.integers(0, 1000, 3000).astype(np.int32)
    elif name == "coherent":
        rng = np.random.default_rng(1)
        table = rng.uniform(0, 1, (2048, 8)).astype(np.float32)
        base = np.repeat(rng.integers(0, 2000, 4), 1024)
        idx = np.clip(base + rng.integers(0, 40, 4096), 0, 2047).astype(np.int32)
    else:  # ragged
        rng = np.random.default_rng(2)
        table = rng.uniform(0, 1, (600, 44)).astype(np.float32)
        idx = rng.integers(0, 600, 777).astype(np.int32)
    return table, idx


@pytest.mark.parametrize("name", ["uniform", "coherent", "ragged"])
def test_plain_matches_pallas_interpret(name):
    table, idx = _case(name)
    want = np.asarray(jax_onehot_gather(jnp.asarray(table), jnp.asarray(idx),
                                        interpret=True))
    gather.reset_launches()
    got = gather.onehot_gather(torch.from_numpy(table), torch.from_numpy(idx))
    assert gather.LAUNCHES["k7"] == 0  # a CPU tensor takes the plain version
    assert got.shape == want.shape == (idx.shape[0], table.shape[1])
    np.testing.assert_array_equal(got.numpy(), want)
    # not table[idx]: the hi/lo split rounds, by at most ~2^-17 of |x|
    exact = table[idx]
    assert not np.array_equal(got.numpy(), exact)
    assert (np.abs(got.numpy() - exact) <= 2.0 ** -16 * np.abs(exact) + 2.0 ** -140).all()


def test_known_values():
    """1/3 and arange + 0.1 come back as the TPU kernel's sums, not as the
    table's values."""
    table = np.stack([np.full(3, 1.0 / 3.0), np.arange(3) + 0.1]).astype(np.float32)
    got = gather.onehot_gather_plain(torch.from_numpy(table),
                                     torch.tensor([0, 1], dtype=torch.int32))
    want = np.asarray(jax_onehot_gather(jnp.asarray(table),
                                        jnp.asarray([0, 1], jnp.int32),
                                        interpret=True))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[0, 0].item() == np.float32(0.33333206)
    assert got[1, 0].item() == np.float32(0.099999905)


def test_out_of_range_indices_are_zero():
    """The JAX kernel's padding rows [T, ceil512(T)) and the negative
    indices it wraps into them return zeros in both packages; the port
    returns zeros for every other index outside [0, T) too."""
    table, _ = _case("uniform")  # T = 1000, padded to 1024
    rng = np.random.default_rng(3)
    idx = rng.integers(0, 1000, 600).astype(np.int32)
    idx[::7] = -1
    idx[1::7] = -24
    idx[2::7] = 1000
    idx[3::7] = 1023
    want = np.asarray(jax_onehot_gather(jnp.asarray(table), jnp.asarray(idx),
                                        interpret=True))
    got = gather.onehot_gather(torch.from_numpy(table), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), want)
    outside = (idx < 0) | (idx >= 1000)
    assert outside.sum() >= 300 and (got.numpy()[outside] == 0.0).all()
    assert (np.abs(got.numpy()[~outside]).sum(-1) > 0.0).all()
    beyond = gather.onehot_gather(torch.from_numpy(table),
                                  torch.tensor([1024, 1500, 2 ** 30, -25, -1000,
                                                -2 ** 31, 5], dtype=torch.int32))
    assert (beyond[:6] == 0.0).all() and (beyond[6] != 0.0).all()


def test_wrapper_refuses_grad_and_unknown_devices():
    table = torch.rand((16, 4), requires_grad=True)
    idx = torch.arange(8, dtype=torch.int32)
    with pytest.raises(RuntimeError, match="K7.*forward-only"):
        gather.onehot_gather(table, idx)
    with torch.no_grad():
        assert gather.onehot_gather(table, idx).shape == (8, 4)
    meta = torch.empty((16, 4), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        gather.onehot_gather(meta, idx)
