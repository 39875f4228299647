"""The split frame over ranks: the traffic kind "orbit_sharded".

One frame of the orbit is split by rows over traffic["ranks"] processes,
one card each (dist/frame.py:render_frame_sharded, halo traffic["halo"]),
and its final rows are gathered onto rank 0 (dist/sharding.py:
gather_rows); the frame ends with rank 0's synchronize on the full final
image, the picture the user sees on one card.

The process that runs the cell (run.py, or a test) is rank 0. It starts
ranks 1 .. n - 1 as child processes of this module (`Ranks`), over a file
store under build/portbench/ranks/, and joins them through
dist/multihost.py:initialize. Rank 0 decides everything: before each
frame it broadcasts one message, a command word and the camera (the
deployment's input path: the user's drag arrives at one process, so the
broadcast is timed inside the frame), and the other ranks follow. A rank
that exits or makes no progress ends the run with exit code 1 and no
result: rank 0 watches the children, and each child dies with rank 0.

The check (check_numbers) is the orbit cells' (check.orbit_numbers): each
stage of a kept frame against the reference stage run on the program's
inputs to it, over the whole image, from every rank's rows gathered into
rank 0's host memory as they are made: the state before the frame, the
1-spp image, the G-buffer and the denoiser's outputs (as
render_frame_sharded hands them to denoise_and_advance and gets them
back), the gathered final image and the state after; and every rank
holds the same frame index and view matrix. The reference's whole frame
run from the state before is no check: it reads 0.3-0.5% of the pixels
off in TAA on sound runs on the card, where the staged check reads 0
(PERF.md).
"""
from __future__ import annotations

import argparse
import atexit
import ctypes
import inspect
import json
import math
import os
import random
import shutil
import signal
import subprocess
import sys
import threading
import time
from types import SimpleNamespace

import torch
import torch.distributed as dist

from portbench import check, scenes, spec
from portbench.reference import camera as rcam
from portbench.reference import frame as rf
from portbench.reference.gbuffer import GBuffer

Tensor = torch.Tensor
# the command words: a frame, a frame kept for the check, the memory peak,
# the stop
FRAME, KEEP, PEAK, STOP = 0.0, 1.0, 2.0, 3.0
CAMERA = (("eye", (3,)), ("cam_to_world", (3, 3)), ("view_proj", (4, 4)),
          ("tan_half_fov", ()))
MESSAGE = 1 + sum(math.prod(shape) for _, shape in CAMERA)
# the state's image fields, row shards on each rank
STATE_ROWS = tuple(f for f in rf.STATE_FIELDS if f != "prev_view_proj")
# the child ranks' entry; a test may start another (a planted fault)
CHILD = [sys.executable, "-m", "portbench.sharded"]
SETUP_S = 1100.0  # a checkout's first run builds the kernels on every rank
FRAME_S = 120.0   # after set-up, the longest wait for a frame or a command
EXIT_S = 120.0    # after the stop, the longest wait for a child to end


class Ranks:
    """Ranks 1 .. n - 1 of a run, started from rank 0 (this process), and
    the watch over them: a child that exits before the stop, with any code,
    or a run that makes no progress by its deadline, ends this process
    with exit code 1 after every child is killed."""

    def __init__(self, n: int, conf: dict, traffic: dict, device: str):
        self.n, self.device = n, device
        self.dir = scenes.WORK_DIR / "ranks" / str(os.getpid())
        shutil.rmtree(self.dir, ignore_errors=True)
        self.dir.mkdir(parents=True)
        self.store = self.dir / "store"
        env = dict(os.environ, OMP_NUM_THREADS="1",
                   PYTHONPATH=os.pathsep.join([str(spec.ROOT), os.environ.get("PYTHONPATH", "")]))
        for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
            env.pop(k, None)
        args = ["--world", str(n), "--store", str(self.store), "--parent", str(os.getpid()),
                "--config", json.dumps(conf), "--traffic", json.dumps(traffic),
                "--device", device]
        self.logs = [self.dir / f"rank{r}.log" for r in range(1, n)]
        self.procs = []
        for r, log in zip(range(1, n), self.logs):
            with open(log, "w") as f:
                self.procs.append(subprocess.Popen(
                    CHILD + args + ["--rank", str(r)], stdout=f, stderr=subprocess.STDOUT,
                    stdin=subprocess.DEVNULL, cwd=spec.ROOT, env=env, start_new_session=True))
        self.deadline = time.monotonic() + SETUP_S
        self.stopping = self.closed = False
        atexit.register(self._at_exit)
        threading.Thread(target=self._watch, daemon=True).start()

    def join(self):
        """Join the process group as rank 0 -> this rank's Mesh."""
        from tpuray_torch.dist import multihost
        multihost.initialize(init_method=f"file://{self.store}", world_size=self.n, rank=0,
                             local_rank=0, device=self.device)
        return multihost.global_mesh()

    def alive(self) -> None:
        """The run made progress: the next deadline is FRAME_S away."""
        self.deadline = time.monotonic() + FRAME_S

    def tails(self) -> str:
        out = []
        for r, log in enumerate(self.logs, 1):
            try:
                text = log.read_text(errors="replace")[-1500:]
            except OSError:
                text = ""
            out.append(f"--- rank {r} (log tail) ---\n{text}")
        return "\n".join(out)

    def _exited(self) -> list[str]:
        return [f"rank {r} exited with code {p.returncode}"
                for r, p in enumerate(self.procs, 1) if p.poll() is not None]

    def _at_exit(self) -> None:
        """Rank 0 ends before the stop (an exception): name the ranks that
        ended first (a rank's connection closes before its process ends:
        a few seconds' grace), then kill the rest."""
        t_end = time.monotonic() + 5.0
        while not self.closed and not self._exited() and time.monotonic() < t_end:
            time.sleep(0.05)
        if not self.closed and self._exited():
            print(f"portbench: {'; '.join(self._exited())}\n{self.tails()}", file=sys.stderr,
                  flush=True)
        self.kill()

    def _watch(self) -> None:
        while not self.closed:
            for r, p in enumerate(self.procs, 1):
                rc = p.poll()
                if rc is not None and (rc != 0 or not self.stopping):
                    self._abort(f"rank {r} exited with code {rc}")
            if time.monotonic() > self.deadline:
                self._abort("the ranks made no progress by the deadline")
            time.sleep(0.1)

    def _abort(self, why: str) -> None:
        if self.closed:
            return
        self.kill()
        print(f"portbench: {why}; the run ends\n{self.tails()}", file=sys.stderr, flush=True)
        os._exit(1)

    def kill(self) -> None:
        """Kill every child still running, with its process group."""
        for p in self.procs:
            if p.poll() is None:
                try:
                    os.killpg(p.pid, signal.SIGKILL)
                except ProcessLookupError:
                    pass
                p.wait()

    def close(self) -> None:
        """After the stop: leave the process group with the other ranks
        (NCCL's communicators are torn down together), wait for every child
        (EXIT_S at most); raises if a child failed."""
        from tpuray_torch.dist import multihost
        self.stopping = True
        self.deadline = time.monotonic() + 2 * EXIT_S
        multihost.shutdown()
        t_end = time.monotonic() + EXIT_S
        try:
            for p in self.procs:
                p.wait(timeout=max(0.1, t_end - time.monotonic()))
        except subprocess.TimeoutExpired:
            pass
        self.closed = True
        self.kill()
        failed = [(r, p.returncode) for r, p in enumerate(self.procs, 1) if p.returncode != 0]
        if failed:
            raise RuntimeError(f"ranks failed (rank, code): {failed}\n{self.tails()}")
        shutil.rmtree(self.dir, ignore_errors=True)


def command(mesh, word: float = FRAME, arrays: dict | None = None):
    """Rank 0 broadcasts (word, camera); every rank -> (word, the program's
    Camera or None), from the same float32 values on every rank."""
    from tpuray_torch.scene.types import Camera
    msg = torch.zeros(MESSAGE, dtype=torch.float32)
    if mesh.rank == 0:
        msg[0] = word
        if arrays is not None:
            msg[1:] = torch.cat([torch.as_tensor(arrays[k], dtype=torch.float32).reshape(-1)
                                 for k, _ in CAMERA])
    on = msg.to(mesh.device)
    dist.broadcast(on, 0)
    if mesh.rank != 0:
        msg = on.cpu()
    word, i, cam = float(msg[0]), 1, {}
    for k, shape in CAMERA:
        cam[k] = msg[i:i + math.prod(shape)].reshape(shape).clone()
        i += math.prod(shape)
    return word, (Camera(**cam) if word in (FRAME, KEEP) else None)


def _batch(ops) -> None:
    for req in dist.batch_isend_irecv(ops):
        req.wait()


def to_rank0(mesh, xs: list[Tensor]) -> list[list[Tensor]] | None:
    """Each tensor of xs (the same shapes on every rank), from every rank
    in rank order, in rank 0's host memory: rank 0 -> [[x of rank 0, of
    rank 1, ...] for x in xs]; the other ranks send and -> None. One batch
    of transfers a tensor: batched, they run on the group's communicator
    (an unbatched send would make NCCL a communicator for each pair)."""
    if mesh.rank != 0:
        for x in xs:
            _batch([dist.P2POp(dist.isend, x.contiguous(), 0)])
        return None
    out = []
    for x in xs:
        bufs = [torch.empty_like(x, memory_format=torch.contiguous_format)
                for _ in range(1, mesh.size)]
        _batch([dist.P2POp(dist.irecv, b, r) for r, b in enumerate(bufs, 1)])
        out.append([check.host(x)] + [check.host(b) for b in bufs])
    return out


class Shard:
    """One rank's part of the run: the program's scene and traversal tables,
    this rank's rows of the frame state, and the frame."""

    def __init__(self, conf: dict, traffic: dict, made: dict, device: str):
        from tpuray_torch.integrator.gather_tables import pack_scene_tables
        from tpuray_torch.integrator.path_tracer import pack_traversal
        from tpuray_torch.scene.config import RenderConfig
        self.device = device
        self.cfg = RenderConfig(width=traffic["width"], height=traffic["height"],
                                **conf.get("render", {}))
        self.halo = traffic["halo"]
        self.scene, self.scene_build_s = scenes.program_scene(conf, made, device)
        self.tables, self.pk = pack_traversal(self.scene), pack_scene_tables(self.scene)

    def start(self, mesh) -> None:
        from tpuray_torch.dist import frame as dframe
        from tpuray_torch.render.frame_state import FrameState
        self.mesh = mesh
        self.state = dframe.shard_state(FrameState.initial(self.cfg.height, self.cfg.width), mesh)

    def rows(self) -> list[Tensor]:
        """This rank's state rows, then its bookkeeping (frame_idx and the
        view matrix, replicated) as one row of 17 floats."""
        s = self.state
        book = torch.cat([torch.full((1,), float(s.frame_idx), device=self.mesh.device),
                          s.prev_view_proj.reshape(-1).to(self.mesh.device, torch.float32)])
        return [getattr(s, f) for f in STATE_ROWS] + [book]

    @torch.no_grad()
    def step(self, cam, keep: bool) -> tuple[dict | None, float]:
        """One frame on this rank, its final rows gathered onto every rank;
        rank 0 waits for the full image. keep: what the check reads goes to
        rank 0's host memory as it is made: every rank's state rows before
        the frame, then its 1-spp rows, the G-buffer and denoiser outputs
        that render_frame_sharded hands to denoise_and_advance and gets back
        (a wrapper passes them through on this frame alone), and its state
        rows after -> (rank 0's record or None, seconds spent copying)."""
        from portbench.clients import sync
        from tpuray_torch.dist import frame as dframe
        from tpuray_torch.dist import sharding
        paused, before, seen = 0.0, None, {}
        advance = dframe.denoise_and_advance
        if keep:
            t = time.perf_counter()
            before = to_rank0(self.mesh, self.rows())
            paused += time.perf_counter() - t

            def passed(*a, **k):
                out = advance(*a, **k)
                seen.update(gbuf=inspect.signature(advance).bind(*a, **k).arguments["gbuf"],
                            svgf=out[1])
                return out
            dframe.denoise_and_advance = passed
        h, w = self.cfg.height, self.cfg.width
        try:
            self.state, final, pt = dframe.render_frame_sharded(
                self.scene, cam, self.state, self.cfg, h, w, self.mesh, halo=self.halo,
                tables=self.tables, pk=self.pk)
        finally:
            dframe.denoise_and_advance = advance
        image = sharding.gather_rows(self.mesh, final)
        if self.mesh.rank == 0:
            sync(self.device)
        if not keep:
            return None, paused
        t = time.perf_counter()
        after = to_rank0(self.mesh, [pt] + [getattr(seen["gbuf"], f) for f in GBuffer._fields]
                         + [getattr(seen["svgf"], f) for f in check.SVGF_FIELDS] + self.rows())
        rec = None if after is None else dict(before=before, after=after,
                                              image=check.host(image))
        return rec, paused + time.perf_counter() - t

    def peak(self) -> Tensor:
        """(this rank's allocator peak in bytes, the forbidden modules it
        holds), for rank 0."""
        from portbench.harness import forbidden_modules
        bad = forbidden_modules()
        if bad:
            print(f"forbidden modules loaded: {bad}", file=sys.stderr, flush=True)
        cuda = torch.device(self.device).type == "cuda"
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        return torch.tensor([float(peak), float(len(bad))], dtype=torch.float64,
                            device=self.mesh.device)


def full(parts: list[list[Tensor]]) -> dict:
    """A state from every rank's rows (Shard.rows) -> the whole image's
    fields, rank 0's frame_idx and view matrix."""
    book = parts[-1][0]
    return dict({f: torch.cat(p) for f, p in zip(STATE_ROWS, parts)},
                frame_idx=int(book[0]), prev_view_proj=book[1:].reshape(4, 4))


def whole(rec: dict) -> dict:
    """A kept frame's record from every rank's rows -> the record of
    check.frame_numbers (the whole image's state before and after, the
    camera, the outputs as the program's FrameOutputs name them), and
    whether every rank holds the same frame_idx and view matrix, before
    the frame and after it."""
    after = [torch.cat(p) for p in rec["after"][:-len(STATE_ROWS) - 1]]
    ng = len(GBuffer._fields)
    out = SimpleNamespace(pt_color=after[0], accum_color=after[0], final=rec["image"],
                          gbuffer=GBuffer(*after[1:1 + ng]),
                          svgf=SimpleNamespace(**dict(zip(check.SVGF_FIELDS, after[1 + ng:]))))
    agree = all(bool((torch.stack(p[-1]) == p[-1][0]).all())
                for p in (rec["before"], rec["after"]))
    return dict(state=full(rec["before"]), camera=rec["camera"], out=out,
                next=full(rec["after"][-len(STATE_ROWS) - 1:]), ranks_agree=agree)


class OrbitSharded:
    """Rank 0's client of the kind "orbit_sharded": the orbit of
    clients.Orbit (the same yaw from the seed, the same frames kept), each
    frame split over traffic["ranks"] ranks."""

    unit = "frame"
    rate_metric, tail_metric = "frame_ms", "frame_ms_p95"

    def __init__(self, conf: dict, traffic: dict, seed: int, device):
        self.conf, self.traffic, self.device = conf, traffic, device
        self.chips = traffic["ranks"]
        self.made = scenes.inputs(conf)  # the OBJ file, before the other ranks read it
        self.ranks = Ranks(self.chips, conf, traffic, device)
        self.shard = Shard(conf, traffic, self.made, device)
        self.cfg, self.scene_build_s = self.shard.cfg, self.shard.scene_build_s
        self.mesh = self.ranks.join()
        self.shard.start(self.mesh)
        rnd = random.Random(seed)
        self.yaw0 = rnd.uniform(0.0, 360.0)
        self.pick = random.Random(seed ^ 0x5EED)
        self.n = 0

    def camera(self, i: int) -> dict:
        cam = self.conf["camera"]
        return rcam.orbit_camera(self.yaw0 + i * self.traffic["yaw_step_deg"],
                                 cam["pitch_deg"], cam["radius"], self.cfg.width,
                                 self.cfg.height, cam["fov_y_deg"])

    def frame(self, keep: bool = False) -> tuple[dict | None, float]:
        arrays = self.camera(self.n)
        _, cam = command(self.mesh, KEEP if keep else FRAME, arrays)
        rec, paused = self.shard.step(cam, keep)
        self.n += 1
        self.ranks.alive()
        if rec is not None:
            rec["camera"] = arrays
        return rec, paused

    def warm_up(self) -> None:
        """Frame 0 (kept for the check) and the rest of the warm-up."""
        self.first, _ = self.frame(keep=True)
        for _ in range(self.traffic["warmup_frames"] - 1):
            self.frame()
        self.kept: list[dict] = []
        self.seen = 0

    def timed(self) -> float:
        """A window unit -> the seconds spent keeping it for the check. The
        frames kept are drawn from the seed as clients.Orbit draws them."""
        k = self.traffic["check_frames"]
        slot = len(self.kept) if len(self.kept) < k else self.pick.randrange(self.seen + 1)
        self.seen += 1
        if slot >= k:
            return self.frame()[1]
        rec, paused = self.frame(keep=True)
        if slot == len(self.kept):
            self.kept.append(rec)
        else:
            self.kept[slot] = rec
        return paused

    def untimed(self) -> dict:
        """A traced frame -> rank 0's G-buffer depth after it (its primary
        hits are where it is not the sky's 1.0)."""
        self.frame()
        return dict(linear_z=self.shard.state.prev_linear_z)

    @staticmethod
    def counts(rec: dict) -> dict:
        """Rank 0's pixels and primary hits in a traced frame."""
        non_sky = rec["linear_z"] != 1.0
        return dict(pixels=int(non_sky.numel()), non_sky=int(non_sky.sum()))

    def memory_peak(self) -> int:
        """The largest rank's allocator peak so far, in bytes; raises where a
        rank holds a forbidden module."""
        command(self.mesh, PEAK)
        got = to_rank0(self.mesh, [self.shard.peak()])[0]
        bad = [r for r, t in enumerate(got) if t[1] > 0]
        if bad:
            raise SystemExit(f"forbidden modules loaded on ranks {bad}\n{self.ranks.tails()}")
        return int(max(t[0] for t in got))

    def scene_context(self) -> dict:
        """The triangle rows the program holds, and the share of frame 0's
        primary rays that hit geometry, over the image and in each rank's
        rows."""
        hits = self.first["after"][-len(STATE_ROWS) - 1 + STATE_ROWS.index("prev_linear_z")]
        by_rank = [float((z != 1.0).float().mean()) for z in hits]
        return dict(triangle_rows=int(self.shard.scene.triangles.count),
                    primary_hit_share=sum(by_rank) / len(by_rank),
                    primary_hit_share_by_rank=by_rank)

    def check_inputs(self) -> list[dict]:
        """The kept frames' records (whole), in host memory: frame 0 first."""
        return [whole(rec) for rec in [self.first] + self.kept]

    def release(self) -> None:
        """Stop every rank and drop the program's state."""
        from portbench.clients import sync
        command(self.mesh, STOP)
        sync(self.device)  # every rank has the stop
        self.shard = None
        self.ranks.close()


def check_numbers(ref_scene, ref_cfg, samples: list[dict], rtol: float, atol: float,
                  device) -> dict:
    """The orbit check's numbers (check.orbit_numbers: each stage against
    the reference run on the program's inputs to it) over the kept frames
    (whole), frame 0 first; `state` reads 1 where the ranks disagree on the
    frame index or the view matrix."""
    numbers = check.orbit_numbers(ref_scene, ref_cfg, samples, rtol, atol, device)
    if not all(smp["ranks_agree"] for smp in samples):
        numbers["state"] = 1.0
    return numbers


def follow(shard: Shard) -> None:
    """A child rank's loop: do what rank 0 broadcasts, until the stop."""
    while True:
        word, cam = command(shard.mesh)
        if word == STOP:
            return
        if word == PEAK:
            to_rank0(shard.mesh, [shard.peak()])
        else:
            shard.step(cam, keep=word == KEEP)


def _die_with_parent(parent: int) -> None:
    """This process is killed when rank 0 ends, however it ends."""
    try:
        ctypes.CDLL(None, use_errno=True).prctl(1, signal.SIGKILL)  # PR_SET_PDEATHSIG
    except (OSError, AttributeError):
        pass
    if os.getppid() != parent:
        os._exit(1)


def child_main(argv=None) -> int:
    """A child rank: its scene, the process group, then follow()."""
    p = argparse.ArgumentParser(prog="python -m portbench.sharded")
    for a in ("--world", "--rank", "--parent"):
        p.add_argument(a, type=int, required=True)
    for a in ("--store", "--config", "--traffic", "--device"):
        p.add_argument(a, required=True)
    args = p.parse_args(argv)
    _die_with_parent(args.parent)
    from portbench.harness import forbidden_modules
    from tpuray_torch.dist import multihost
    if args.device == "cuda":
        torch.cuda.set_device(args.rank)
    torch.set_num_threads(1)
    conf, traffic = json.loads(args.config), json.loads(args.traffic)
    shard = Shard(conf, traffic, scenes.inputs(conf, write=False), args.device)
    multihost.initialize(init_method=f"file://{args.store}", world_size=args.world,
                         rank=args.rank, local_rank=args.rank, device=args.device)
    shard.start(multihost.global_mesh())
    follow(shard)
    multihost.shutdown()
    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr, flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(child_main())
