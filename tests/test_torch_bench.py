"""The port's benchmark entry point (supernova_tpu_torch/bench.py) on the
CPU at smoke size: `python -m supernova_tpu_torch bench --device cpu`
prints the reference bench.py's two JSON lines, the count line first, and
its count equals the reference's count_kmers on the same inputs; without a
card `bench` (cuda, the default) exits nonzero and prints no result."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
LINE_KEYS = {"metric", "value", "unit", "vs_baseline", "extra"}


def run_bench(*args, **env):
    e = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    e.update(PYTHONPATH=str(REPO), **env)
    return subprocess.run([sys.executable, "-m", "supernova_tpu_torch", *args],
                          capture_output=True, text=True, cwd=REPO, env=e, timeout=240)


def reference_n_valid():
    """The reference bench.py's smoke count (same seed and shapes) through
    the JAX package's count_kmers."""
    import jax.numpy as jnp

    from supernova_tpu.kmer.count import count_kmers

    rng = np.random.default_rng(0)
    n_reads, rl = 4_000, 150
    nb = n_reads * rl
    genome = rng.integers(0, 4, 12_000)
    starts = rng.integers(0, len(genome) - rl, n_reads)
    codes_ext = np.zeros(nb + 128, dtype=np.int32)
    codes_ext[:nb] = genome[np.add.outer(starts, np.arange(rl))].reshape(-1)
    pos_read = np.repeat(np.arange(n_reads, dtype=np.int32), rl)
    glen_pos = np.full(nb, rl, dtype=np.int32)
    bc_pos = np.repeat(rng.integers(1, 1_000_000, n_reads).astype(np.int32), rl)
    t = count_kmers(*map(jnp.asarray, (codes_ext, pos_read, glen_pos, bc_pos)), uniform_rl=rl)
    return int(t.n_valid)


def test_bench_smoke_prints_the_reference_lines():
    res = run_bench("bench", "--device", "cpu", BENCH_SMOKE="1")
    assert res.returncode == 0, res.stderr[-2000:]
    lines = [json.loads(x) for x in res.stdout.strip().splitlines()]
    assert len(lines) == 2 and all(set(x) == LINE_KEYS for x in lines)
    first, second = lines
    assert first["metric"] == second["metric"] == "kmer_count_throughput"
    assert first["unit"] == "kmers/s/chip" and first["extra"]["pather"] == "pending"
    assert first["value"] > 0 and first["vs_baseline"] == round(first["value"] / 20e6, 3)
    extra = second["extra"]
    assert extra["reads_aligned_per_s"] > 0 and extra["placed_frac"] > 0.9
    assert extra["pather_vs_baseline"] == round(extra["reads_aligned_per_s"] / 40e3, 3)
    assert first["extra"]["n_valid"] == extra["n_valid"] == reference_n_valid() > 0


def test_bench_without_a_card_exits_nonzero():
    res = run_bench("bench", CUDA_VISIBLE_DEVICES="")
    assert res.returncode != 0 and not res.stdout.strip()
    assert "torch.cuda.is_available() is False" in res.stderr
