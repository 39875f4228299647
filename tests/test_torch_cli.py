"""The port's command line (tpuray_torch/cli/main.py) on the CPU.

render and animate take tpuray's options with tpuray's defaults, plus
--device (cuda by default). A render writes a PNG and a FrameState
checkpoint that --resume continues from: 3 frames, then 2 resumed, save the
same state as 5 frames in one run. render --elastic runs the supervised
loop (utils/elastic.py): its checkpoint equals the plain render's state,
and a run with an injected device fault equals it bit for bit. The
subcommands that are not ported raise NotImplementedError naming their
ROADMAP.md item.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import tpuray.cli.main as jcli
import tpuray.io.filesystem as jfs

from tpuray_torch.cli import main as cli
from tpuray_torch.io import filesystem
from tpuray_torch.io.image import read_png
from tpuray_torch.utils.checkpoint import load_frame_state

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _parsed(module, monkeypatch, argv):
    """The argparse namespace main() hands to the subcommand."""
    seen = {}
    for fs in (filesystem, jfs):
        monkeypatch.setattr(fs, "_extra_roots", [])
    for name in ("cmd_render", "cmd_animate"):
        monkeypatch.setattr(module, name, lambda args: seen.update(vars(args)) or 0)
    assert module.main(argv) == 0
    return {k: v for k, v in seen.items() if k not in ("fn", "device")}


@pytest.mark.parametrize("argv", [
    ["render"], ["animate"],
    ["--asset-root", "assets", "render", "--scene", "table", "--frames", "3", "--size", "64",
     "--depth", "1", "--view", "atrous", "--yaw", "5", "--checkpoint-every", "4",
     "--reference-quirks", "--dump-all-views"],
    ["animate", "--deg-per-frame", "3", "--every", "2", "--out-prefix", "x", "--radius", "3"],
], ids=["render_defaults", "animate_defaults", "render_options", "animate_options"])
def test_options_match_tpuray(monkeypatch, argv):
    assert _parsed(cli, monkeypatch, argv) == _parsed(jcli, monkeypatch, argv)


def test_render_writes_png_and_resumes(tmp_path):
    out, ck, ck2, ck5 = (str(tmp_path / n) for n in ("r.png", "a.npz", "b.npz", "c.npz"))
    base = ["render", "--device", "cpu", "--size", "32"]
    assert cli.main(base + ["--frames", "3", "--out", out, "--checkpoint", ck]) == 0
    img = read_png(out)
    assert img.shape == (32, 32, 3) and 0.0 < img.mean() < 1.0
    assert load_frame_state(ck).frame_idx == 3
    assert cli.main(base + ["--frames", "2", "--out", out, "--resume", ck,
                            "--checkpoint", ck2]) == 0
    assert cli.main(base + ["--frames", "5", "--out", str(tmp_path / "s.png"),
                            "--checkpoint", ck5]) == 0
    resumed, straight = load_frame_state(ck2), load_frame_state(ck5)
    assert resumed.frame_idx == straight.frame_idx == 5
    for f in ("illum_hist", "moments", "history_len", "accum_color", "taa_color"):
        assert torch.equal(getattr(resumed, f), getattr(straight, f)), f
    assert float(resumed.history_len.max()) == 5.0


def test_render_dump_all_views(tmp_path):
    out = str(tmp_path / "v.png")
    assert cli.main(["render", "--device", "cpu", "--size", "16", "--frames", "1",
                     "--out", out, "--dump-all-views"]) == 0
    names = sorted(p for p in os.listdir(tmp_path) if p.startswith("v_"))
    assert names == sorted(f"v_{v}.png" for v in cli._VIEWS)


def test_animate_writes_sequence(tmp_path):
    prefix = str(tmp_path / "anim")
    assert cli.main(["animate", "--device", "cpu", "--size", "16", "--frames", "3",
                     "--every", "2", "--out-prefix", prefix]) == 0
    assert sorted(os.listdir(tmp_path)) == ["anim_0000.png", "anim_0002.png"]


@pytest.mark.parametrize("argv,item", [
    (["train"], "item 15"), (["view"], "item 15"), (["bench"], "item 3"),
    (["render", "--device", "cpu", "--size", "16", "--frames", "2", "--elastic"], None)],
    ids=["train", "view", "bench", "elastic"])
def test_unported_commands_raise(argv, item, tmp_path):
    """The commands not ported yet raise naming their item; render --elastic
    is ported and runs."""
    if item is None:
        ck, out = str(tmp_path / "ck.npz"), str(tmp_path / "e.png")
        assert cli.main(argv + [ck, "--out", out]) == 0
        assert load_frame_state(ck).frame_idx == 2 and os.path.exists(out)
        return
    with pytest.raises(NotImplementedError, match=item):
        cli.main(argv)


def test_render_elastic_resumes_bit_identical(tmp_path, monkeypatch, capsys):
    """render --elastic with a device fault injected before frame 3 restores
    the checkpoint of frame 2 and replays: its final state equals the plain
    render's bit for bit (no compaction switch within 4 frames)."""
    from tpuray_torch.render import renderer

    base = ["render", "--device", "cpu", "--size", "16", "--frames", "4"]
    plain = str(tmp_path / "plain.npz")
    assert cli.main(base + ["--out", str(tmp_path / "p.png"), "--checkpoint", plain]) == 0

    calls, real = [], renderer.render_frame

    def flaky(scene, camera, state, *args, **kw):
        calls.append(state.frame_idx)
        if state.frame_idx == 3 and calls.count(3) == 1:
            raise RuntimeError("CUDA error: an illegal memory access was encountered")
        return real(scene, camera, state, *args, **kw)

    monkeypatch.setattr(renderer, "render_frame", flaky)
    ck = str(tmp_path / "ck.npz")
    assert cli.main(base + ["--out", str(tmp_path / "e.png"), "--elastic", ck,
                            "--checkpoint-every", "2"]) == 0
    assert calls == [0, 1, 2, 3, 2, 3]
    err = capsys.readouterr().err
    assert "elastic: 5 frames, 1 faults, 1 restores" in err
    assert '"frames": 4' in err  # each frame index recorded once
    a, b = load_frame_state(ck), load_frame_state(plain)
    assert a.frame_idx == b.frame_idx == 4
    for f in ("illum_hist", "variance_hist", "moments", "history_len", "accum_color",
              "taa_color", "prev_view_proj"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.parametrize("scene", ["reference", "table"])
def test_file_scenes_need_their_asset(monkeypatch, scene):
    monkeypatch.delenv("TPURAY_ASSET_ROOT", raising=False)
    with pytest.raises(FileNotFoundError, match=".obj"):
        cli.main(["render", "--device", "cpu", "--scene", scene, "--size", "16"])


def test_cuda_is_the_default_device(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["render", "--size", "16", "--out", str(tmp_path / "x.png")])


def test_cli_runs_without_jax(tmp_path):
    """As a module, in an interpreter where jax and tpuray cannot load."""
    code = ("import sys, runpy; sys.modules['jax'] = None; sys.modules['tpuray'] = None; "
            "sys.argv = ['main'] + sys.argv[1:]; "
            "runpy.run_module('tpuray_torch.cli.main', run_name='__main__')")
    out = str(tmp_path / "p.png")
    proc = subprocess.run(
        [sys.executable, "-c", code, "render", "--device", "cpu", "--size", "16",
         "--frames", "2", "--out", out], cwd=ROOT, capture_output=True, text=True,
        timeout=120, env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert proc.returncode == 0, proc.stderr
    assert '"frames": 2' in proc.stderr
    assert np.isfinite(read_png(out)).all()
