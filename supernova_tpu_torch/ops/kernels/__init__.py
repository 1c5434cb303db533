"""The port's hand-written Hopper kernels, each beside its plain twin.

  K1 kmer_extract.sliding_words  <- ops/pallas/kmer_extract.py
  K2 compact.compact             <- ops/pallas/compact.py
  K3 run_reduce.run_reduce       <- ops/pallas/run_reduce.py
  K4 sort.lex_argsort            <- ops/pallas/sort.py
  K5 scan_max.scan_max           <- none (jax.lax.cummax, lowered by XLA)

Each wrapper runs its plain PyTorch twin for CPU tensors and launches its
CUDA kernel for CUDA tensors (raising on anything the kernel does not
take).  `wrapper.launches` counts kernel launches made through the wrapper
and `wrapper.bytes` the bytes they must move, from each launch's shapes by
the module's `launch_bytes` (each input byte read once, each output byte
written once).  K2's bytes of kept rows are known on the card only: each
launch adds them to a 0-d tensor there (`compact.kept_bytes`), read when
the counts are resolved.
"""
from __future__ import annotations

from . import compact, kmer_extract, run_reduce, scan_max, sort

WRAPPERS = {
    "kmer_extract": kmer_extract.sliding_words,
    "compact": compact.compact,
    "run_reduce": run_reduce.run_reduce,
    "sort": sort.lex_argsort,
    "scan_max": scan_max.scan_max,
}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def launches_since(before: dict) -> dict:
    """Launches a wrapper made since launch_counts() returned `before`."""
    return {name: fn.launches - before[name] for name, fn in WRAPPERS.items()}


def counters() -> dict:
    """Every wrapper's "<name>.launches" and "<name>.bytes", with K2's kept
    rows' bytes still on the card under "compact.kept_bytes" (a tuple of
    0-d tensors, one a device): a snapshot taken with no sync."""
    out = {}
    for name, fn in WRAPPERS.items():
        out[f"{name}.launches"] = fn.launches
        out[f"{name}.bytes"] = fn.bytes
    out["compact.kept_bytes"] = tuple(compact.compact.kept_bytes.values())
    return out


def resolved(snapshot: dict) -> dict:
    """A counters() snapshot in integers: K2's kept bytes read from the card
    (waiting for the launches that compute them) and added to its bytes."""
    out = {k: v for k, v in snapshot.items() if k != "compact.kept_bytes"}
    out["compact.bytes"] += sum(int(t) for t in snapshot["compact.kept_bytes"])
    return out


def byte_counts() -> dict:
    """{name: bytes} the wrapper's launches have moved so far."""
    r = resolved(counters())
    return {name: r[f"{name}.bytes"] for name in WRAPPERS}


def reset_launch_counts() -> None:
    """Set every wrapper's launches and bytes to 0."""
    for fn in WRAPPERS.values():
        fn.launches = 0
        fn.bytes = 0
    compact.compact.kept_bytes.clear()
