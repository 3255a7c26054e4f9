"""parallel/elastic — the elastic training loop (train-through-failure).

Copy of ``ompi_tpu/parallel/elastic.py``.  Closes the ULFM recovery loop on
a training job: periodic checkpoints through the MPI-IO path
(:mod:`ompi_tpu_torch.parallel.checkpoint`, a ``COMPLETE`` marker after
every rank's collective write), and on ``ProcFailedError`` /
``RevokedError`` the full forward-recovery sequence —

    detect → revoke → ERA agree on survivors → shrink →
    (optionally) respawn replacements verified against the job pset →
    restore → resume

Every phase gets a trace span (``elastic_revoke`` … ``elastic_restore``,
with ``elastic_detect``/``elastic_resume`` instants) and the end-to-end
detect→resume latency lands in the ``elastic_recovery`` trace histogram.
The trainer's step loop carries chaos's ``step`` kill point and pacing
point (``tpurun --mca otpu_chaos_spec 'kill:rank=2,step=7'``).

**Bit-exactness by construction.**  The gradient of global sample ``j`` at
step ``s`` is an integer field and the learning rate a power of two, so
every parameter update is an exact dyadic rational and the global-batch sum
is independent of both summation order and world width.  A run that loses
a rank, shrinks (optionally respawning back to full width) and restores
from the last checkpoint finishes with parameters **bit-identical** to a
failure-free run restored from the same checkpoint step
(:func:`reference_run`).

The parameter vector is a float64 tensor on the rank's card (``device=``
names another, ``"cpu"`` for the tests); each step's gradient field is
built with numpy, moved to that device, and the per-step allreduce sends
the tensor through the host tier.

Replacement ranks run ``python -m ompi_tpu_torch.parallel.elastic <conf>``
(:func:`replacement_main`): they meet the survivors through
``get_parent``, merge (parents first, so the survivors' comm ranks are
stable), restore from the shared checkpoint directory, and join the
training loop mid-stream.
"""
from __future__ import annotations

import json
import os
import time
from typing import Optional

import numpy as np

#: power-of-two learning rate: updates are exact dyadic rationals
DEFAULT_LR = 2.0 ** -6

_P1, _P2, _P3 = 1_000_003, 7_919, 104_729


def grad_field(step: int, lo: int, hi: int, dims: int,
               seed: int = 0) -> np.ndarray:
    """Summed integer gradient of global samples [lo, hi) at ``step``.

    Values are small integers (|g| <= 8 per sample), so any partition of
    the global batch sums to the same float64 bit pattern."""
    j = np.arange(int(lo), int(hi), dtype=np.int64)[:, None]
    d = np.arange(int(dims), dtype=np.int64)[None, :]
    g = (int(step) * _P1 + j * _P2 + d * _P3 + int(seed) * 13) % 17 - 8
    return g.sum(axis=0).astype(np.float64)


def partition(rank: int, size: int, total: int) -> tuple:
    """Contiguous [lo, hi) split of ``total`` items over ``size`` ranks
    (first ``total % size`` ranks take one extra)."""
    base, rem = divmod(int(total), int(size))
    lo = rank * base + min(rank, rem)
    return lo, lo + base + (1 if rank < rem else 0)


def reference_run(w0: np.ndarray, from_step: int, to_step: int,
                  global_batch: int, lr: float = DEFAULT_LR,
                  seed: int = 0) -> np.ndarray:
    """Failure-free single-process replay from ``w0`` at ``from_step``
    — the oracle the elastic run must match bit-for-bit."""
    w = np.array(w0, dtype=np.float64, copy=True)
    for s in range(int(from_step), int(to_step)):
        w -= lr * grad_field(s, 0, global_batch, w.shape[0], seed)
    return w


class ElasticTrainer:
    """Train-through-failure driver over a host communicator."""

    def __init__(self, comm, ckpt_dir: str, model_size: int = 16,
                 global_batch: int = 32, lr: float = DEFAULT_LR,
                 ckpt_every: int = 5, respawn: bool = False,
                 target_size: Optional[int] = None, seed: int = 0,
                 device=None):
        import torch

        from ompi_tpu_torch.api.errhandler import ERRORS_RETURN
        from ompi_tpu_torch.base import cudaenv

        comm.set_errhandler(ERRORS_RETURN)   # ULFM: errors raise
        self.comm = comm
        self.ckpt_dir = str(ckpt_dir)
        self.model_size = int(model_size)
        self.global_batch = int(global_batch)
        self.lr = float(lr)
        self.ckpt_every = max(1, int(ckpt_every))
        self.respawn = bool(respawn)
        self.target_size = int(target_size if target_size is not None
                               else comm.size)
        self.seed = int(seed)
        self.device = cudaenv.resolve_device(device)
        self.step = 0
        self.w = torch.zeros(self.model_size, dtype=torch.float64,
                             device=self.device)
        self.recoveries: list = []       # one phase-duration dict each
        self._total_steps = 0

    # -- checkpoint ------------------------------------------------------
    def _ckpt_path(self, step: int) -> str:
        return os.path.join(self.ckpt_dir, f"step{int(step):06d}")

    def _checkpoint(self) -> None:
        from ompi_tpu_torch.parallel import checkpoint
        from ompi_tpu_torch.runtime import trace

        t0 = time.perf_counter_ns()
        path = self._ckpt_path(self.step)
        lo, hi = partition(self.comm.rank, self.comm.size,
                           self.model_size)
        tree = {
            "w": checkpoint.Shard(self.w[lo:hi], [lo], [self.model_size]),
            "step": np.array([self.step], np.int64),
        }
        checkpoint.save(path, tree, comm=self.comm)
        # completion marker AFTER the collective writes: restore only ever
        # trusts a checkpoint every rank finished (a kill mid-save must not
        # leave a half-written step looking restorable)
        self.comm.barrier()
        if self.comm.rank == 0:
            with open(os.path.join(path, "COMPLETE"), "w") as f:
                f.write(str(self.step))
        if trace.enabled:
            trace.span("elastic_checkpoint", "ft", t0,
                       args={"step": self.step})

    def latest_complete_step(self) -> int:
        """Highest checkpoint step with a completion marker."""
        from ompi_tpu_torch.api.errors import ErrorClass, MpiError

        best = -1
        try:
            names = os.listdir(self.ckpt_dir)
        except OSError:
            names = []
        for name in names:
            if name.startswith("step") and os.path.exists(
                    os.path.join(self.ckpt_dir, name, "COMPLETE")):
                best = max(best, int(name[4:]))
        if best < 0:
            raise MpiError(
                ErrorClass.ERR_INTERN,
                f"no complete checkpoint under {self.ckpt_dir!r} — "
                "cannot recover")
        return best

    def _restore(self, step: int) -> None:
        """Load the dense checkpoint onto this rank's device and take the
        whole vector under the CURRENT world shape — reshard-on-restore is
        what makes checkpoint-level elasticity work."""
        from ompi_tpu_torch.parallel import checkpoint

        tree = checkpoint.load(self._ckpt_path(step), device=self.device)
        self.w = tree["w"].clone()
        self.step = int(tree["step"].reshape(-1)[0])

    # -- training --------------------------------------------------------
    def _train_step(self) -> None:
        import torch

        lo, hi = partition(self.comm.rank, self.comm.size,
                           self.global_batch)
        local = torch.from_numpy(grad_field(
            self.step, lo, hi, self.model_size, self.seed)).to(self.device)
        total = torch.from_numpy(np.array(
            self.comm.allreduce(local), np.float64)).to(self.device)
        self.w = self.w - self.lr * total
        self.step += 1

    def train(self, steps: int):
        """Run to ``steps``, recovering from failures on the way; returns
        the parameter tensor."""
        from ompi_tpu_torch.api.errors import ProcFailedError, RevokedError
        from ompi_tpu_torch.ft import chaos
        from ompi_tpu_torch.runtime import trace

        self._total_steps = int(steps)
        while self.step < self._total_steps:
            if chaos.enabled:
                # the kill-at-step schedule ('kill:rank=R,step=S') and the
                # designed-straggler pacing point ('delay:ms=8,rank=R,
                # site=step')
                chaos.kill_point("step", n=self.step)
                chaos.pace("step")
            # step window span (cat "step"; args carry the step index so
            # windows match across ranks even after a ring wrap)
            _t0 = trace.now() if trace.enabled else 0
            _step0 = self.step
            try:
                if self.step % self.ckpt_every == 0:
                    self._checkpoint()
                self._train_step()
            except (ProcFailedError, RevokedError) as exc:
                if trace.enabled:
                    trace.span("step", "step", _t0,
                               args={"step": _step0, "failed": True})
                self._recover(exc)
                continue
            if trace.enabled:
                trace.span("step", "step", _t0, args={"step": _step0})
        return self.w

    # -- recovery --------------------------------------------------------
    def _phase(self, rec: dict, name: str, fn):
        from ompi_tpu_torch.runtime import trace

        t0 = time.perf_counter_ns()
        try:
            return fn()
        finally:
            dur = time.perf_counter_ns() - t0
            rec[name + "_ms"] = dur / 1e6
            if trace.enabled:
                trace.span("elastic_" + name, "ft", t0,
                           args={"step": rec["detect_step"]})

    def _recover(self, exc) -> None:
        from ompi_tpu_torch.ft import state as ft_state
        from ompi_tpu_torch.runtime import trace

        t_detect = time.perf_counter_ns()
        rec = {"detect_step": self.step, "kind": type(exc).__name__,
               "failed": sorted(ft_state.failed_ranks())}
        if trace.enabled:
            trace.instant("elastic_detect", "ft",
                          args={"step": self.step, "kind": rec["kind"]})
        self._phase(rec, "revoke", self._revoke)
        self._phase(rec, "agree", self._agree_survivors)
        self._phase(rec, "shrink", self._shrink)
        if self.respawn and self.comm.size < self.target_size:
            self._phase(rec, "respawn", self._respawn)
        self._phase(rec, "restore",
                    lambda: self._restore(self.latest_complete_step()))
        total_ns = time.perf_counter_ns() - t_detect
        rec["total_ms"] = total_ns / 1e6
        rec["resume_step"] = self.step
        rec["world_size"] = self.comm.size
        self.recoveries.append(rec)
        # detect→resume latency percentile machinery (p50/p99 pvars)
        trace.hist_record("elastic_recovery", 0, total_ns)
        if trace.enabled:
            trace.instant("elastic_resume", "ft",
                          args={"step": self.step, "size": self.comm.size})

    def _revoke(self) -> None:
        # idempotent: the peer that hit the failure first may have revoked
        # already (we then came here via RevokedError)
        if not self.comm.is_revoked():
            self.comm.revoke()

    def _agree_survivors(self) -> None:
        """ERA agreement among the survivors: loops ack+agree until the
        group's failure knowledge is uniform, so shrink starts from one
        agreed view."""
        from ompi_tpu_torch.api.errors import ProcFailedError, RevokedError

        while True:
            try:
                self.comm.agree(1)
                return
            except (ProcFailedError, RevokedError):
                self.comm.ack_failed()

    def _shrink(self) -> None:
        from ompi_tpu_torch.api.errhandler import ERRORS_RETURN

        new = self.comm.shrink()
        new.set_errhandler(ERRORS_RETURN)
        self.comm = new

    def _conf(self) -> dict:
        return {"ckpt_dir": self.ckpt_dir, "model_size": self.model_size,
                "global_batch": self.global_batch, "lr": self.lr,
                "ckpt_every": self.ckpt_every, "respawn": self.respawn,
                "target_size": self.target_size, "seed": self.seed,
                "device": str(self.device), "steps": self._total_steps}

    def _respawn(self) -> None:
        """Spawn replacements back to ``target_size``, verified against
        the dynamic ``mpi://job/<id>`` pset before the merge — a
        replacement that is not in the launcher's job set must fail
        loudly, not silently join the training comm."""
        import sys

        from ompi_tpu_torch.api.errhandler import ERRORS_RETURN
        from ompi_tpu_torch.api.errors import ErrorClass, MpiError

        n = self.target_size - self.comm.size
        argv = [sys.executable, "-m", "ompi_tpu_torch.parallel.elastic",
                json.dumps(self._conf())]
        inter = self.comm.spawn(argv, n, root=0)
        job = getattr(inter, "spawn_job", None)
        client = getattr(self.comm.rte, "client", None)
        if job is not None and client is not None:
            entry = client.pset_get(f"mpi://job/{job}")
            members = set(entry["members"]) if entry else set()
            children = set(inter.remote_group.world_ranks)
            if children != members:
                raise MpiError(
                    ErrorClass.ERR_SPAWN,
                    f"respawned ranks {sorted(children)} do not match "
                    f"the mpi://job/{job} pset {sorted(members)}")
        full = inter.merge(high=False)   # survivors keep low comm ranks
        full.set_errhandler(ERRORS_RETURN)
        self.comm = full

    def report(self) -> dict:
        return {"step": self.step, "world_size": self.comm.size,
                "recoveries": self.recoveries,
                "w": self.w.cpu().tolist()}


def replacement_main(argv: Optional[list] = None) -> int:
    """Entry point of a respawned replacement rank (``python -m
    ompi_tpu_torch.parallel.elastic <json-conf>``): merge with the
    survivors (parents first), restore from the shared checkpoint
    directory, and join the training loop mid-stream."""
    import sys

    import ompi_tpu_torch
    from ompi_tpu_torch.api.errors import ErrorClass, MpiError

    args = sys.argv[1:] if argv is None else list(argv)
    conf = json.loads(args[0])
    steps = int(conf.pop("steps"))
    ompi_tpu_torch.init(device=conf.get("device"))
    parent = ompi_tpu_torch.get_parent()
    if parent is None:
        raise MpiError(ErrorClass.ERR_SPAWN,
                       "elastic replacement started without a parent "
                       "intercommunicator (run via ElasticTrainer "
                       "respawn, not directly)")
    full = parent.merge(high=True)       # survivors first, then us
    trainer = ElasticTrainer(full, **conf)
    trainer._total_steps = steps
    trainer._restore(trainer.latest_complete_step())
    trainer.train(steps)
    ompi_tpu_torch.finalize()
    return 0


if __name__ == "__main__":
    raise SystemExit(replacement_main())
