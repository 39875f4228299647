"""The port's utilities on the CPU, against tpuray.

- save_pytree / load_pytree (utils/checkpoint.py): split_trainable's params
  saved by one package load into the other's, both ways, bit for bit (the
  same leaf order: dict keys sorted, dataclass fields in order); the port's
  loaded leaves are on the device of the leaves they replace and require
  grad where those did; a file of another tree is refused.
- profile_trace (utils/metrics.py) writes a Chrome trace that names the
  ops and the program's spans run inside it.
- build_env_cache (sampling/envmap.py, float32 on the image's device):
  at 64 texels wide within tests/test_envmap.py's atol 2e-5 of
  build_env_cache_jnp and of env_cache_py, its indices equal to
  env_cache_py's. At 512 the pdf stays within atol 2e-5 of env_cache_py's,
  but float32 cumsums move a searchsorted index where a sample point sits
  within rounding of a CDF step: 2 of the 262,144 row indices land one
  row over (1/256) against the float64 build; build_env_cache_jnp moves
  605. Held: every index equal to env_cache_py's or one texel step from
  it, and no more of them moved than in tpuray's float32 build.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from tpuray.sampling import envmap as jenv
from tpuray.scene.procedural import make_test_scene as jmake_test_scene
from tpuray.train import optimize as jopt
from tpuray.utils import checkpoint as jckpt

from tpuray_torch.sampling import envmap
from tpuray_torch.scene import host
from tpuray_torch.scene.procedural import make_test_scene
from tpuray_torch.train import optimize
from tpuray_torch.utils import checkpoint
from tpuray_torch.utils.metrics import FRAME, profile_trace, span

torch.set_num_threads(2)


def _fields(params):
    """{group.field: numpy} of a params dict of either package."""
    return {f"{g}.{f.name}": np.asarray(
        x.detach().numpy() if isinstance(x := getattr(t, f.name), torch.Tensor) else x)
        for g, t in params.items() for f in dataclasses.fields(t)}


@pytest.fixture(scope="module")
def params():
    ours, _ = optimize.split_trainable(make_test_scene(subdiv=0, env_width=16), device="cpu")
    theirs, _ = jopt.split_trainable(jmake_test_scene(subdiv=0, env_width=16))
    return ours, theirs


def _perturbed_jax(theirs):
    rs = np.random.default_rng(5)
    return {g: t.replace(**{f.name: jnp.asarray(rs.random(getattr(t, f.name).shape),
                                                jnp.float32)
                            for f in dataclasses.fields(t)})
            for g, t in theirs.items()}


def test_params_saved_by_tpuray_load_into_the_port(tmp_path, params):
    ours, theirs = params
    theirs = _perturbed_jax(theirs)
    path = str(tmp_path / "j.npz")
    jckpt.save_pytree(path, theirs)
    got = checkpoint.load_pytree(path, ours)
    want = _fields(theirs)
    assert set(_fields(got)) == set(want)
    for k, v in _fields(got).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)
    leaves = optimize.parameters(got)
    assert all(x.requires_grad and x.is_leaf for x in leaves)
    assert all(x.device == y.device for x, y in zip(leaves, optimize.parameters(ours)))


def test_params_saved_by_the_port_load_into_tpuray(tmp_path, params):
    ours, theirs = params
    with torch.no_grad():
        for i, x in enumerate(optimize.parameters(ours)):
            x.copy_(torch.arange(x.numel(), dtype=x.dtype).reshape(x.shape) + 100 * i)
    path = str(tmp_path / "t.npz")
    checkpoint.save_pytree(path, ours)
    got = jckpt.load_pytree(path, theirs)
    want = _fields(ours)
    for k, v in _fields(got).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)
    back = checkpoint.load_pytree(path, ours)
    for k, v in _fields(back).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)


def test_pytree_leaf_order_and_refusals(tmp_path):
    tree = {"b": (torch.ones(2), np.zeros(3, np.int32)), "a": [torch.full((1,), 7.0)],
            "c": None, "d": 3}
    assert [tuple(x.shape) for x in checkpoint.tree_leaves(tree)] == [(1,), (2,), (3,)]
    path = str(tmp_path / "x.npz")
    checkpoint.save_pytree(path, tree)
    back = checkpoint.load_pytree(path, tree)
    assert list(back) == list(tree) and back["c"] is None and back["d"] == 3
    assert isinstance(back["b"], tuple) and isinstance(back["b"][1], np.ndarray)
    assert float(back["a"][0]) == 7.0 and back["b"][1].dtype == np.int32
    with pytest.raises(ValueError, match="leaves"):
        checkpoint.load_pytree(path, {"a": torch.ones(1)})
    with pytest.raises(ValueError, match="shape"):
        checkpoint.load_pytree(path, {"b": (torch.ones(3), np.zeros(3)), "a": [torch.ones(1)]})


def test_profile_trace(tmp_path):
    log_dir = tmp_path / "trace"
    with profile_trace(str(log_dir)):
        with span(FRAME):
            torch.matmul(torch.ones(8, 8), torch.ones(8, 8))
    files = list(log_dir.glob("*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("matmul" in e.get("name", "") for e in events)
    assert any(e.get("name") == FRAME for e in events)


@pytest.mark.parametrize("width", [64, 512])
def test_build_env_cache(width):
    img = host.procedural_room_envmap(width).astype(np.float32)  # as a scene holds it
    got = envmap.build_env_cache(torch.from_numpy(img)).numpy()
    dev = np.asarray(jenv.build_env_cache_jnp(jnp.asarray(img)))
    ref = host.env_cache_py(img)
    assert got.shape == ref.shape and got.dtype == np.float32
    np.testing.assert_allclose(got[..., 2], ref[..., 2], atol=2e-5)
    if width == 64:
        np.testing.assert_allclose(got, dev, atol=2e-5)
        np.testing.assert_allclose(got, ref, atol=2e-5)
        np.testing.assert_array_equal(got[..., :2], ref[..., :2])
    h = img.shape[0]
    step = np.asarray([1.0 / width, 1.0 / h], np.float32)
    moved = got[..., :2] != ref[..., :2]
    np.testing.assert_allclose(np.abs(got[..., :2] - ref[..., :2])[moved],
                               np.broadcast_to(step, moved.shape)[moved], rtol=1e-6)
    assert moved.sum() <= (dev[..., :2] != ref[..., :2]).sum()
