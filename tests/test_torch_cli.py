"""The port's command line (tpuray_torch/cli/main.py) on the CPU.

render, animate, train and view take tpuray's options with tpuray's
defaults, plus --device (cuda by default) and render's --trace DIR, which
writes a Chrome trace of the frames holding the program's spans, and the
frames' counters. A render writes a PNG and a
FrameState checkpoint that --resume continues from: 3 frames, then 2
resumed, save the same state as 5 frames in one run. render --elastic runs
the supervised loop (utils/elastic.py): its checkpoint equals the plain
render's state, and a run with an injected device fault equals it bit for
bit. train at 16x16, depth 1, 3 steps takes tpuray's cmd_train's
per-step losses (tolerance argued in its test) and writes both PNGs; at
256x256, depth 2, 5 steps (a test marked slow, ~2 min) it follows
tpuray's overshooting trajectory within the same tolerance. view
serves /state on the port it prints and exits 0 on Ctrl-C. bench is
tests/test_torch_bench.py's.
"""
import contextlib
import io
import json
import os
import re
import signal
import subprocess
import sys
import urllib.request

import numpy as np
import pytest
import torch

import tpuray.cli.main as jcli
import tpuray.io.filesystem as jfs
import tpuray.train.optimize as jopt
from tpuray.integrator import disney as jdisney

from tpuray_torch.cli import main as cli
from tpuray_torch.io import filesystem
from tpuray_torch.io.image import read_png
from tpuray_torch.train import optimize
from tpuray_torch.utils.checkpoint import load_frame_state

from tests.test_torch_train import _guarded_gtr1, _guarded_gtr2

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _parsed(module, monkeypatch, argv):
    """The argparse namespace main() hands to the subcommand, but the
    port's own options (--device, render's --trace)."""
    seen = {}
    for fs in (filesystem, jfs):
        monkeypatch.setattr(fs, "_extra_roots", [])
    for name in ("cmd_render", "cmd_animate", "cmd_train", "cmd_view"):
        monkeypatch.setattr(module, name, lambda args: seen.update(vars(args)) or 0)
    assert module.main(argv) == 0
    return {k: v for k, v in seen.items() if k not in ("fn", "device", "trace")}


@pytest.mark.parametrize("argv", [
    ["render"], ["animate"],
    ["--asset-root", "assets", "render", "--scene", "table", "--frames", "3", "--size", "64",
     "--depth", "1", "--view", "atrous", "--yaw", "5", "--checkpoint-every", "4",
     "--reference-quirks", "--dump-all-views"],
    ["animate", "--deg-per-frame", "3", "--every", "2", "--out-prefix", "x", "--radius", "3"],
    ["train"], ["view"],
    ["train", "--scene", "table", "--steps", "7", "--size", "32", "--depth", "2", "--lr",
     "0.1", "--out-prefix", "fit"],
    ["view", "--scene", "reference", "--size", "64", "--host", "0.0.0.0", "--port", "0",
     "--config", "c.json", "--reference-quirks"],
], ids=["render_defaults", "animate_defaults", "render_options", "animate_options",
        "train_defaults", "view_defaults", "train_options", "view_options"])
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


def test_render_trace_writes_spans(tmp_path):
    trace_dir = tmp_path / "traces"
    assert cli.main(["render", "--device", "cpu", "--size", "16", "--frames", "2",
                     "--out", str(tmp_path / "t.png"), "--trace", str(trace_dir)]) == 0
    (path,) = trace_dir.glob("trace_*.json")
    names = {e.get("name") for e in json.loads(path.read_text())["traceEvents"]}
    assert {"tpuray.frame", "tpuray.trace_paths", "tpuray.svgf", "tpuray.taa"} <= names
    records = json.loads((trace_dir / "frame_records.json").read_text())
    assert [r["frame_idx"] for r in records] == [0, 1]
    assert all(r["lanes"] == 32 * 32 and r["shaded_lanes"] >= 512 for r in records)
    assert cli.main(["render", "--device", "cpu", "--size", "16", "--frames", "1",
                     "--out", str(tmp_path / "u.png")]) == 0
    assert len(list(trace_dir.glob("trace_*.json"))) == 1
    elastic = tmp_path / "elastic"
    assert cli.main(["render", "--device", "cpu", "--size", "16", "--frames", "1",
                     "--elastic", str(tmp_path / "ck.npz"), "--out", str(tmp_path / "e.png"),
                     "--trace", str(elastic)]) == 0
    (record,) = json.loads((elastic / "frame_records.json").read_text())
    assert record["frame_idx"] == 0 and record["lanes"] == 32 * 32


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


def test_render_elastic_runs(tmp_path):
    """render --elastic renders its frames and writes its checkpoint."""
    ck, out = str(tmp_path / "ck.npz"), str(tmp_path / "e.png")
    assert cli.main(["render", "--device", "cpu", "--size", "16", "--frames", "2",
                     "--elastic", ck, "--out", out]) == 0
    assert load_frame_state(ck).frame_idx == 2 and os.path.exists(out)


def _train_losses(module, make_module, argv):
    """Every step's loss at full precision (make_train_step's step wrapped)
    and what the command printed, of `module`.main(argv)."""
    seen, real = [], make_module.make_train_step

    def make(*a, **kw):
        init, step = real(*a, **kw)

        def recorded(*sa, **skw):
            state, loss = step(*sa, **skw)
            seen.append(float(loss))
            return state, loss
        return init, recorded

    err = io.StringIO()
    make_module.make_train_step = make
    try:
        with contextlib.redirect_stderr(err):
            assert module.main(argv) == 0
    finally:
        make_module.make_train_step = real
    return np.asarray(seen), err.getvalue()


def test_train_matches_tpuray(tmp_path):
    """cmd_train in both packages at 16x16, depth 1, 3 steps (Adam at the
    default lr 0.05 on every leaf), tpuray with the port's sin-from-cos in
    its GTR samplers (tests/test_torch_train.py; without it its
    clearcoat_gloss gradient is NaN and every leaf goes NaN after one
    step). The per-step losses agree within rtol 1e-3: the target and the
    first image differ by XLA's contracted multiply-adds (tests/
    test_torch_frame.py's trace_paths tolerance), which moves the first
    loss by ~3e-6 of itself; an Adam step moves each leaf by about lr in
    the sign of its gradient, so it could step the other way only where
    that gradient sits at the rounding level, and such a leaf barely moves
    the loss. Measured: 3e-6, 8e-7 and 3e-5 of the loss (and at most 1e-4
    over 8 steps at 32x32)."""
    argv = ["train", "--size", "16", "--depth", "1", "--steps", "3"]
    orig = jdisney.sample_gtr1, jdisney.sample_gtr2
    jdisney.sample_gtr1, jdisney.sample_gtr2 = _guarded_gtr1, _guarded_gtr2
    try:
        want, _ = _train_losses(jcli, jopt, argv + ["--out-prefix", str(tmp_path / "j")])
    finally:
        jdisney.sample_gtr1, jdisney.sample_gtr2 = orig
    prefix = str(tmp_path / "t")
    got, printed = _train_losses(cli, optimize, argv + ["--out-prefix", prefix,
                                                        "--device", "cpu"])
    assert len(got) == len(want) == 3 and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-3)
    assert got[-1] < got[0]
    lines = re.findall(r"step (\d+): loss ([0-9.]+)", printed)
    assert [int(i) for i, _ in lines] == [0, 1, 2]
    assert [float(x) for _, x in lines] == [float(f"{x:.6f}") for x in got]
    assert f"final loss {got[-1]:.6f}" in printed
    for name in ("target", "fit"):
        img = read_png(f"{prefix}_{name}.png")
        assert img.shape == (16, 16, 3) and np.isfinite(img).all() and img.max() > 0


@pytest.mark.slow
def test_train_at_256_follows_tpuray():
    """cmd_train at 256x256, depth 2, 5 steps (chip_smoke.py phase 20's
    second run; ~3 min on the CPU, most of it tpuray's): the per-step
    losses within test_train_matches_tpuray's rtol 1e-3 of tpuray's. At lr
    0.05 Adam on every leaf overshoots here in both packages: the loss
    after the first step is above the first (4x on this scene), so the
    card's run is held to finite losses, not to a falling one."""
    argv = ["train", "--size", "256", "--depth", "2", "--steps", "5", "--out-prefix",
            os.path.join(ROOT, "build", "train_256_cpu")]
    orig = jdisney.sample_gtr1, jdisney.sample_gtr2
    jdisney.sample_gtr1, jdisney.sample_gtr2 = _guarded_gtr1, _guarded_gtr2
    try:
        want, _ = _train_losses(jcli, jopt, argv)
    finally:
        jdisney.sample_gtr1, jdisney.sample_gtr2 = orig
    got, _ = _train_losses(cli, optimize, argv + ["--device", "cpu"])
    np.testing.assert_allclose(got, want, rtol=1e-3)
    assert got[1] > got[0] and want[1] > want[0]


def test_view_serves_until_ctrl_c():
    """view --port 0 --device cpu as a user runs it: the URL line names the
    port taken; /state answers; SIGINT ends it with exit 0."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "tpuray_torch.cli.main", "view", "--port", "0",
         "--device", "cpu", "--size", "16"], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=dict(os.environ, OMP_NUM_THREADS="2"))
    try:
        line = proc.stdout.readline()
        url = re.search(r"http://\S+/", line)
        assert url, line
        with urllib.request.urlopen(url.group(0) + "state", timeout=60) as r:
            state = json.loads(r.read())
        assert state["width"] == 16 and state["params"]["max_tracing_depth"] == 2
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=30) == 0, proc.stderr.read()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


@pytest.mark.parametrize("cmd", ["train", "view"])
def test_train_and_view_default_to_cuda(monkeypatch, cmd):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main([cmd, "--size", "16", "--port", "0"] if cmd == "view"
                 else [cmd, "--size", "16", "--steps", "1"])


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
