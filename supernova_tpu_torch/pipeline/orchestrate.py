"""Martian-equivalent stage orchestration: DAG scheduling, chunking,
retries, and pipestance state.

The port's own copy of supernova_tpu/pipeline/orchestrate.py, kept equal
to it by tests/test_torch_hostcopies.py apart from host_id and n_hosts,
which read the torch.distributed rank and world size where the original
reads JAX's process index and count: the port imports nothing of the JAX
package.

The reference's runtime is Martian `mrp` (SURVEY.md §1 L6-L7): every stage
declares split/main/join, runs as retryable chunk processes, and the
pipestance directory records per-stage state so a failed run re-enters
where it stopped.  TPU-native re-expression (SURVEY.md §5.8): one Python
process per host over the device mesh; device-sharded stages run SPMD on
all hosts, host-side stages run everywhere deterministically (or are
host-0-gated by the caller); the orchestrator contributes the Martian
pieces JAX does not have — a stage DAG with dependency ordering, a
split/main/join chunk protocol (process-pooled on one host, round-robin
across hosts in a multi-host job), per-stage retry policy, wall/attempt
accounting, and a `pipestance.json` state file for re-entry (the
`a.*`-checkpoint analogue at stage granularity, DF.cc:147-155).
"""
from __future__ import annotations

import json
import time
import traceback
from concurrent.futures import ProcessPoolExecutor
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence


class StageError(RuntimeError):
    """A stage failed after exhausting its retries (exit-185 analogue)."""

    def __init__(self, stage: str, message: str):
        super().__init__(f"stage {stage}: {message}")
        self.stage = stage


def host_id() -> int:
    """This host's index in the multi-host job (0 on a single host): its
    torch.distributed rank once a process group is initialized."""
    import torch.distributed as tdist

    return tdist.get_rank() if tdist.is_available() and tdist.is_initialized() else 0


def n_hosts() -> int:
    import torch.distributed as tdist

    return tdist.get_world_size() if tdist.is_available() and tdist.is_initialized() else 1


@dataclass
class StageDef:
    """One pipeline stage.  `fn(ctx)` for unchunked stages; chunked stages
    declare `split(ctx) -> [chunk_args]`, `fn(ctx, chunk_args)` per chunk,
    and `join(ctx, results) -> result` (the Martian protocol,
    mro/_assembler_stages.mro)."""

    name: str
    fn: Callable
    deps: Sequence[str] = ()
    split: Optional[Callable] = None
    join: Optional[Callable] = None
    max_retries: int = 1
    threads: int = 1  # advisory, recorded in state (split using threads=N)
    mem_gb: Optional[float] = None  # advisory, recorded


@dataclass
class StageState:
    status: str = "pending"  # pending | running | complete | failed
    attempts: int = 0
    wall_s: float = 0.0
    error: str = ""
    chunks: int = 0


class Orchestrator:
    """Runs a stage DAG with pipestance-state re-entry.

    State lives in <outdir>/pipestance.json.  A stage marked complete is
    skipped on re-entry ONLY if the caller's `restore` hook can rebuild its
    result (usually from the stage's own npz checkpoint); otherwise it
    reruns — results are in-memory, the state file only stores status.
    """

    def __init__(self, outdir: str | Path, processes: int = 0):
        self.outdir = Path(outdir)
        self.outdir.mkdir(parents=True, exist_ok=True)
        self.state_path = self.outdir / "pipestance.json"
        self.state: Dict[str, StageState] = {}
        self.processes = processes  # >0: run chunks in a process pool
        if self.state_path.exists():
            try:
                raw = json.loads(self.state_path.read_text())
                for k, v in raw.get("stages", {}).items():
                    self.state[k] = StageState(**v)
            except Exception:
                self.state = {}

    # ------------------------------------------------------------- state io

    def _dump(self):
        self.state_path.write_text(
            json.dumps(
                {
                    "host": host_id(),
                    "n_hosts": n_hosts(),
                    "stages": {k: vars(v) for k, v in self.state.items()},
                },
                indent=1,
            )
        )

    def stage_state(self, name: str) -> StageState:
        return self.state.setdefault(name, StageState())

    # ------------------------------------------------------------ execution

    def run_stage(
        self,
        name: str,
        fn: Callable[[], Any],
        max_retries: int = 1,
        restore: Optional[Callable[[], Any]] = None,
    ) -> Any:
        """Run one stage with retry + state accounting.  `restore()` may
        rebuild a completed stage's result from its checkpoint (returning
        non-None skips the rerun) — the START=<stage> re-entry hook."""
        st = self.stage_state(name)
        if st.status == "complete" and restore is not None:
            try:
                got = restore()
            except Exception:
                got = None
            if got is not None:
                return got
        last_err = ""
        for attempt in range(max_retries + 1):
            st.status = "running"
            st.attempts += 1
            self._dump()
            t0 = time.time()
            try:
                out = fn()
                st.status = "complete"
                st.wall_s += time.time() - t0
                st.error = ""
                self._dump()
                return out
            except Exception as e:  # noqa: BLE001 — stage isolation boundary
                st.wall_s += time.time() - t0
                last_err = f"{type(e).__name__}: {e}"
                st.error = last_err
                st.status = "failed"
                self._dump()
                # full traceback to a per-stage file (the StageError message
                # keeps only the one-liner; OOM forensics need the frames)
                try:
                    tb_path = self.outdir / f"_stage_{name}_traceback.txt"
                    with open(tb_path, "a") as f:
                        f.write(
                            f"--- attempt {attempt + 1} "
                            f"{time.strftime('%Y-%m-%d %H:%M:%S')} ---\n"
                        )
                        f.write(traceback.format_exc())
                except OSError:
                    pass
                if attempt >= max_retries or isinstance(e, KeyboardInterrupt):
                    break
        raise StageError(name, last_err)

    def run(self, stages: List[StageDef], ctx: Any) -> Dict[str, Any]:
        """Execute a DAG of StageDefs in dependency order; returns
        {stage: result}.  Chunked stages fan their chunks over a process
        pool (one host) and round-robin chunks across hosts in a
        multi-host job (each host computes its share; single-host runs
        compute everything)."""
        by_name = {s.name: s for s in stages}
        for s in stages:
            for d in s.deps:
                if d not in by_name:
                    raise ValueError(f"stage {s.name}: unknown dep {d}")
        done: Dict[str, Any] = {}
        remaining = list(stages)
        while remaining:
            ready = [s for s in remaining if all(d in done for d in s.deps)]
            if not ready:
                raise ValueError("dependency cycle in stage DAG")
            for s in ready:
                done[s.name] = self._run_def(s, ctx, done)
                remaining.remove(s)
        return done

    def _run_def(self, s: StageDef, ctx: Any, done: Dict[str, Any]) -> Any:
        st = self.stage_state(s.name)
        st.chunks = 0

        def body():
            if s.split is None:
                return s.fn(ctx, done)
            chunks = list(s.split(ctx, done))
            st.chunks = len(chunks)
            mine = [
                c
                for i, c in enumerate(chunks)
                if i % n_hosts() == host_id()
            ]
            if self.processes and len(mine) > 1:
                with ProcessPoolExecutor(
                    max_workers=min(self.processes, len(mine))
                ) as pool:
                    results = list(pool.map(_chunk_runner, [(s.fn, ctx, c) for c in mine]))
            else:
                results = [s.fn(ctx, c) for c in mine]
            if s.join is None:
                return results
            return s.join(ctx, results)

        return self.run_stage(s.name, body, max_retries=s.max_retries)


def _chunk_runner(packed):
    fn, ctx, chunk = packed
    return fn(ctx, chunk)
