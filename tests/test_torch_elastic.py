"""The port's elastic render loop (tpuray_torch/utils/elastic.py) on the
CPU, as tests/test_elastic.py holds tpuray's: PyTorch-shaped faults are
classified, an uninterrupted run checkpoints as it goes, a run with
injected device faults resumes from its checkpoints bit for bit equal to
an uninterrupted run, a persistent fault re-raises after max_restarts and
a programming error re-raises at once. Frames: the port's render_frame at
32x32, depth 1, two a-trous iterations (tests/test_elastic.py's config).
"""
import numpy as np
import pytest
import torch
import torch.distributed as dist

from tpuray_torch.render.frame_state import FrameState
from tpuray_torch.render.renderer import render_frame
from tpuray_torch.scene.camera import OrbitCamera
from tpuray_torch.scene.config import RenderConfig
from tpuray_torch.scene.procedural import make_test_scene
from tpuray_torch.utils.checkpoint import load_frame_state
from tpuray_torch.utils.elastic import ElasticStats, is_device_fault, run_elastic

torch.set_num_threads(2)

H = W = 32


@pytest.fixture(scope="module")
def setup():
    scene = make_test_scene(subdiv=1, env_width=32)
    cfg = RenderConfig(width=W, height=H, max_tracing_depth=1,
                       num_atrous_iterations=2)
    cam = OrbitCamera(width=W, height=H)

    @torch.no_grad()
    def frame_fn(state, frame):
        # a moving camera keyed on the frame index: a replay sees the same view
        cam.yaw_deg = 0.5 * frame
        new_state, _ = render_frame(scene, cam.snapshot(), state, cfg, H, W)
        return new_state

    return frame_fn, FrameState.initial(H, W)


def _cuda_error(msg):
    cls = getattr(torch, "AcceleratorError", RuntimeError)
    try:
        return cls(msg)
    except TypeError:  # a constructor that wants more arguments
        return RuntimeError(msg)


@pytest.mark.parametrize("exc,fault", [
    (RuntimeError("CUDA error: an illegal memory access was encountered\nCUDA kernel "
                  "errors might be asynchronously reported"), True),
    (_cuda_error("CUDA error: unspecified launch failure"), True),
    (RuntimeError("  CUDA error: uncorrectable ECC error encountered"), True),
    (dist.DistBackendError("NCCL communicator was aborted on rank 1"), True),
    (dist.DistNetworkError("Connection reset by peer"), True),
    (dist.DistStoreError("Timed out after 601 seconds waiting for clients"), True),
    (RuntimeError("NCCL error in: ProcessGroupNCCL.cpp:1234, unhandled system error"), True),
    (RuntimeError("ncclRemoteError: A call failed possibly due to a network error"), True),
    (RuntimeError("[Rank 0] Watchdog caught collective operation timeout: WorkNCCL"), True),
    (torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB"), False),
    (RuntimeError("CUDA error: out of memory"), False),
    (RuntimeError("CUDA error: invalid configuration argument"), False),
    (RuntimeError("K1 trace_packets launch failed: cudaError_t 9"), False),
    (RuntimeError("the kernel saw a CUDA error: an illegal address"), False),  # not a prefix
    (RuntimeError("mat1 and mat2 shapes cannot be multiplied (4x3 and 4x4)"), False),
    (ValueError("bad argument"), False),
    (TypeError("CUDA error: not a runtime error"), False),
    (KeyboardInterrupt(), False),
], ids=lambda x: type(x).__name__ if isinstance(x, BaseException) else str(x))
def test_fault_classification(exc, fault):
    assert is_device_fault(exc) is fault


def test_uninterrupted_run(setup, tmp_path):
    frame_fn, st0 = setup
    ck = str(tmp_path / "ck.npz")
    final, stats = run_elastic(frame_fn, st0, 6, ck, checkpoint_every=2)
    assert isinstance(stats, ElasticStats)
    assert (stats.frames_done, stats.faults, stats.restores) == (6, 0, 0)
    assert stats.checkpoints == 1 + 3  # at the start, then frames 2, 4, 6
    assert final.frame_idx == 6
    saved = load_frame_state(ck)
    assert saved.frame_idx == 6
    np.testing.assert_array_equal(saved.taa_color.numpy(), final.taa_color.numpy())


def test_fault_resume_bit_identical(setup, tmp_path):
    frame_fn, st0 = setup
    ref_final, _ = run_elastic(frame_fn, st0, 7, str(tmp_path / "ref.npz"),
                               checkpoint_every=3)

    armed = {4, 6}  # device faults injected before frames 4 and 6

    def flaky(state, frame):
        if frame in armed:
            armed.discard(frame)
            raise RuntimeError("CUDA error: an illegal memory access was encountered")
        return frame_fn(state, frame)

    restores = []
    final, stats = run_elastic(flaky, st0, 7, str(tmp_path / "ck.npz"),
                               checkpoint_every=3, on_restore=lambda: restores.append(1))
    assert (stats.faults, stats.restores, len(restores)) == (2, 2, 2)
    assert stats.replayed_frames == 1 + 0  # frame 3 replayed after the first fault
    assert [f for f, _, _ in stats.fault_log] == [4, 6]
    assert final.frame_idx == 7
    for f in ("taa_color", "accum_color", "illum_hist", "variance_hist", "moments",
              "history_len", "prev_normal", "prev_linear_z", "prev_view_proj"):
        np.testing.assert_array_equal(getattr(final, f).numpy(),
                                      getattr(ref_final, f).numpy(), err_msg=f)


def test_first_frame_fault_restores_this_run(setup, tmp_path):
    """A stale checkpoint of another run is never trusted: the loop writes
    its own initial checkpoint before the first frame."""
    frame_fn, st0 = setup
    ck = str(tmp_path / "ck.npz")
    run_elastic(frame_fn, st0, 3, ck)  # leaves frame 3's state behind
    armed = {0}

    def flaky(state, frame):
        if frame in armed:
            armed.discard(frame)
            raise dist.DistNetworkError("Connection reset by peer")
        return frame_fn(state, frame)

    final, stats = run_elastic(flaky, st0, 2, ck)
    assert (stats.restores, stats.frames_done, final.frame_idx) == (1, 2, 2)


def test_persistent_fault_reraises(setup, tmp_path):
    frame_fn, st0 = setup
    calls = []

    def always_fails(state, frame):
        calls.append(frame)
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    with pytest.raises(RuntimeError, match="illegal memory access"):
        run_elastic(always_fails, st0, 4, str(tmp_path / "ck.npz"), max_restarts=2)
    assert calls == [0, 0, 0]  # the first try and two restarts


@pytest.mark.parametrize("exc", [ValueError("logic bug"),
                                 torch.cuda.OutOfMemoryError("CUDA out of memory.")])
def test_programming_error_immediate(setup, tmp_path, exc):
    frame_fn, st0 = setup
    calls = []

    def bug(state, frame):
        calls.append(frame)
        raise exc

    with pytest.raises(type(exc)):
        run_elastic(bug, st0, 4, str(tmp_path / "ck.npz"))
    assert calls == [0]
