"""tpuray_torch.sampling vs tpuray.sampling on the CPU.

RNG: bit-exact (int64 with a 32-bit mask reproduces uint32 wraparound).
Env map: directions (uv, and the NEE table's direction columns) within
rtol 1e-6: XLA's and PyTorch's float32 trig differ by one ulp on a few
percent of inputs; atol covers components that round to ~0. Radiance and
pdf are bilinear lookups of a steep map (a lamp and a window) at those
directions, and the pdf divides by cos(elevation): the one-ulp direction
differences grow to ~1e-5 relative in radiance and ~1e-4 in pdf near the
poles, so those are held to rtol 1e-4."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from tpuray.sampling import envmap as jenv
from tpuray.sampling import rng as jrng
from tpuray.scene.builder import procedural_room_envmap
from tpuray.io.fallback import env_cache_py

from tpuray_torch.sampling import envmap, rng

torch.set_num_threads(2)


def _seeds(n=20000):
    r = np.random.default_rng(5)
    s = r.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    s[:4] = [0, 1, 0x7FFFFFFF, 0xFFFFFFFF]
    return s


def test_wang_hash_and_rand_bit_exact():
    s = _seeds()
    bits, nxt = rng.wang_hash(torch.from_numpy(s.astype(np.int64)))
    jbits, _ = jrng.wang_hash(jnp.asarray(s))
    np.testing.assert_array_equal(bits.numpy(), np.asarray(jbits).astype(np.int64))
    u, _ = rng.rand(torch.from_numpy(s.astype(np.int64)))
    ju, _ = jrng.rand(jnp.asarray(s))
    assert u.dtype == torch.float32
    np.testing.assert_array_equal(u.numpy(), np.asarray(ju))


@pytest.mark.parametrize("frame", [0, 1, 7, 12345, 2**32 - 1])
def test_pixel_seed_bit_exact(frame):
    """Includes negative py (padded tile rows below the image)."""
    r = np.random.default_rng(frame % 1000)
    px = r.integers(0, 4096, 5000).astype(np.int32)
    py = r.integers(-32, 4096, 5000).astype(np.int32)
    got = rng.pixel_seed(torch.from_numpy(px), torch.from_numpy(py), frame)
    want = jrng.pixel_seed(jnp.asarray(px), jnp.asarray(py), jnp.uint32(frame))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int64))


def test_stream_of_draws_bit_exact():
    px = np.arange(3000, dtype=np.int32)
    py = (np.arange(3000, dtype=np.int32) * 7) % 811 - 16
    s = rng.pixel_seed(torch.from_numpy(px), torch.from_numpy(py), 9)
    js = jrng.pixel_seed(jnp.asarray(px), jnp.asarray(py), 9)
    for _ in range(6):
        u, s = rng.rand(s)
        ju, js = jrng.rand(js)
        np.testing.assert_array_equal(u.numpy(), np.asarray(ju))


def test_sobol_bit_exact():
    np.testing.assert_array_equal(rng.SOBOL_V, jrng.SOBOL_V)
    idx = np.concatenate([np.arange(2048), [2**31 - 1, 2**32 - 1]]).astype(np.uint32)
    for dim in range(8):
        np.testing.assert_array_equal(
            rng.sobol(dim, idx), np.asarray(jrng.sobol(dim, jnp.asarray(idx))))
    for frame in (1, 2, 77, 4096):
        for bounce in range(4):
            np.testing.assert_array_equal(
                rng.sobol_vec2(frame, bounce),
                np.asarray(jrng.sobol_vec2(jnp.uint32(frame), bounce)))


def test_cranley_patterson_bit_exact():
    r = np.random.default_rng(6)
    px = r.integers(0, 2048, 4000).astype(np.int32)
    py = r.integers(-32, 2048, 4000).astype(np.int32)
    u, v = rng.cranley_patterson_offsets(torch.from_numpy(px), torch.from_numpy(py))
    ju, jv = jrng.cranley_patterson_offsets(jnp.asarray(px), jnp.asarray(py))
    np.testing.assert_array_equal(u.numpy(), np.asarray(ju))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    p = rng.sobol_vec2(13, 1)
    x, y = rng.cranley_patterson_rotate(p, u, v)
    jx, jy = jrng.cranley_patterson_rotate(jnp.asarray(p), ju, jv)
    np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy))


@pytest.fixture(scope="module")
def env_maps():
    img = procedural_room_envmap(64)
    cache = env_cache_py(img)
    return img.astype(np.float32), cache


def _dirs(n, seed):
    d = np.random.default_rng(seed).standard_normal((n, 3)).astype(np.float32)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


def test_env_lookups_match(env_maps):
    img, cache = env_maps
    d = _dirs(4096, 7)
    u, v = envmap.dir_to_uv(torch.from_numpy(d))
    ju, jv = jenv.dir_to_uv(jnp.asarray(d))
    np.testing.assert_allclose(u.numpy(), np.asarray(ju), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=1e-6, atol=1e-6)
    rad = envmap.env_radiance(torch.from_numpy(img), torch.from_numpy(d))
    jrad = jenv.env_radiance(jnp.asarray(img), jnp.asarray(d))
    np.testing.assert_allclose(rad.numpy(), np.asarray(jrad), rtol=1e-4, atol=1e-6)
    p = envmap.env_pdf(torch.from_numpy(cache), torch.from_numpy(d))
    jp = jenv.env_pdf(jnp.asarray(cache), jnp.asarray(d), 0)
    np.testing.assert_allclose(p.numpy(), np.asarray(jp), rtol=1e-4, atol=1e-6)


def test_env_nee_table_and_sample_match(env_maps):
    img, cache = env_maps
    table = envmap.pack_env_nee_table(torch.from_numpy(img), torch.from_numpy(cache))
    jtable = np.array(jenv.pack_env_nee_table(jnp.asarray(img), jnp.asarray(cache)))
    assert table.shape == jtable.shape == (32, 64, 8)
    np.testing.assert_allclose(table.numpy()[..., :3], jtable[..., :3],
                               rtol=1e-6, atol=2e-7)
    np.testing.assert_allclose(table.numpy()[..., 3:], jtable[..., 3:],
                               rtol=1e-4, atol=1e-6)
    r = np.random.default_rng(8)
    xi1, xi2 = (r.random(5000).astype(np.float32) for _ in range(2))
    got = envmap.sample_env_nee(torch.from_numpy(jtable), torch.from_numpy(xi1),
                                torch.from_numpy(xi2))
    want = jenv.sample_env_nee(jnp.asarray(jtable), jnp.asarray(xi1), jnp.asarray(xi2))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
