"""StatLogger: typed named metrics registry + threshold alerts.

The port's own copy of supernova_tpu/stats/logger.py, kept equal to it by
tests/test_torch_hostcopies.py: the port imports nothing of the JAX package.

Analogue of the reference's StatLogger (10X/DfTools.h:47-260: log /
issue_alert / dump_csv / dump_json / persist across binaries) and of the
alarms registry (tenkit/lib/python/tenkit/alarms/alarms-supernova.json).
Stats persist across stages by reloading the JSON store (the reference
reloads a.perf_stats, CP.cc:172-177).
"""
from __future__ import annotations

import json
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, Optional


@dataclass
class Alert:
    stat: str
    test: str  # python expression over `value`, e.g. "value < 25"
    action: str  # "alarm" | "exit"
    message: str


# The customer-facing alert envelope, carried over from
# tenkit/lib/python/tenkit/alarms/alarms-supernova.json (see BASELINE.md).
DEFAULT_ALERTS: List[Alert] = [
    Alert("valid_bc_perc", "value < 25", "exit",
          "% reads with valid barcode is {value:.1f}; expected >= 80%."),
    Alert("valid_bc_perc", "value < 80", "alarm",
          "% reads with valid barcode is {value:.1f}; ideal >= 80%."),
    Alert("mean_read_len", "value < 125", "exit",
          "mean read length {value:.0f} < 125; assembly not supported."),
    Alert("mean_read_len", "value < 150", "alarm",
          "mean read length {value:.0f} < 150; ideal 150."),
    Alert("rpb_N50", "value > 10000", "exit",
          "N50 reads per barcode {value:.0f} > 10000; check library."),
    Alert("rpb_N50", "value > 3000", "alarm",
          "N50 reads per barcode {value:.0f} > 3000; ideal ~1000."),
    Alert("q30_r2_perc", "value < 65", "alarm",
          "Q30 fraction on R2 is {value:.1f}%; ideal >= 75%."),
    # insert-size envelope (alarms-supernova.json:130-152, TR stage)
    Alert("median_ins_sz", "value < 100", "exit",
          "median insert size {value:.0f} < 100; library unusable."),
    Alert("median_ins_sz", "value < 300", "alarm",
          "median insert size {value:.0f} < 300; ideal 350-400."),
    Alert("proper_pairs_perc", "value < 75", "alarm",
          "proper pair fraction {value:.1f}%; ideal >= 85%."),
    Alert("worst_cycle_q2_frac", "value > 50", "alarm",
          "{value:.0f}% of bases at one read cycle have Q<=2; likely a "
          "sequencer failure at that cycle."),
    # coverage envelope (alarms-supernova.json:73-85)
    Alert("est_coverage", "value < 15", "alarm",
          "estimated raw coverage {value:.0f}x < 15x; ideal 38-56x."),
    Alert("est_coverage", "value > 90", "alarm",
          "estimated raw coverage {value:.0f}x > 90x; ideal 38-56x."),
    # input-size / barcode-library envelope (alarms-supernova.json df tier)
    Alert("nreads", "value > 2147483647", "exit",
          "{value:.0f} reads exceeds the supported maximum (2^31-1)."),
    Alert("big_bc_perc", "value > 10", "exit",
          "{value:.1f}% of reads sit in huge (>=50k-read) barcodes; "
          "the barcode library is degenerate."),
    Alert("est_genome_size", "value < 100000000", "alarm",
          "estimated genome size {value:.0f} < 100 Mb; outside the "
          "supported envelope."),
    Alert("est_genome_size", "value > 3200000000", "alarm",
          "estimated genome size {value:.0f} > 3.2 Gb; outside the "
          "supported envelope."),
    # resource / library-prep envelope (alarms-supernova.json:17-36)
    Alert("mem_per_read", "value < 0.0001066", "alarm",
          "only {value:.6f} MB of memory available per input read; the "
          "run is at risk of running out of memory."),
    Alert("loading_mass", "value < 0.6", "alarm",
          "estimated loading mass {value:.3g} ng < 0.6 ng; library "
          "complexity may be reduced."),
    Alert("loading_mass", "value > 2.5", "alarm",
          "estimated loading mass {value:.3g} ng > 2.5 ng; the effect "
          "of overloading is unknown."),
    # molecule / line health (alarms-supernova.json pr tier)
    Alert("lw_mean_mol_len", "value < 40000", "alarm",
          "length-weighted mean molecule length {value:.0f} < 40 kb; "
          "input DNA may be too fragmented."),
    Alert("n_lines", "value < 1", "exit",
          "assembly produced no lines."),
]


@dataclass
class LogEntry:
    name: str
    value: Any
    gloss: str = ""
    cs: bool = False  # customer-facing (goes into summary_cs.csv)
    stage: str = ""


class StatLogger:
    """Accumulates stats; evaluates alerts; dumps json/csv/text."""

    def __init__(self, alerts: Optional[List[Alert]] = None):
        self.entries: Dict[str, LogEntry] = {}
        self.alerts = DEFAULT_ALERTS if alerts is None else alerts
        self.raised: List[dict] = []
        self._t0 = time.time()

    def log(self, name: str, value, gloss: str = "", cs: bool = False, stage: str = ""):
        self.entries[name] = LogEntry(name, value, gloss, cs, stage)
        for al in self.alerts:
            if al.stat == name and eval(al.test, {}, {"value": value}):
                self.raised.append(
                    {
                        "stat": name,
                        "action": al.action,
                        "message": al.message.format(value=value),
                    }
                )

    def get(self, name: str, default=None):
        e = self.entries.get(name)
        return e.value if e else default

    def exit_alerts(self) -> List[dict]:
        return [a for a in self.raised if a["action"] == "exit"]

    def log_elapsed(self, stage: str):
        self.log(f"etime_{stage}_h", (time.time() - self._t0) / 3600.0, stage=stage)

    def dump_json(self, path: str | Path, cs_only: bool = False):
        data = {
            k: e.value
            for k, e in self.entries.items()
            if (e.cs or not cs_only)
        }
        Path(path).write_text(json.dumps(data, indent=1, default=str) + "\n")

    def dump_csv(self, path: str | Path):
        lines = ["name,value,gloss"]
        for e in self.entries.values():
            if e.cs:
                lines.append(f"{e.name},{e.value},{e.gloss}")
        Path(path).write_text("\n".join(lines) + "\n")

    def dump_text(self, path: str | Path):
        """Human-readable summary table (the reference's summary.txt /
        printed report, AssemblyStats.cc:743-800)."""
        lines = ["-" * 64, "SUMMARY", "-" * 64]
        for e in self.entries.values():
            if not e.cs:
                continue
            v = e.value
            if isinstance(v, float):
                v = f"{v:,.2f}"
            elif isinstance(v, int):
                v = f"{v:,}"
            lines.append(f"{str(v):>18}  {e.name:<22} {e.gloss}")
        lines.append("-" * 64)
        Path(path).write_text("\n".join(lines) + "\n")

    def dump_alerts(self, path: str | Path):
        Path(path).write_text(json.dumps(self.raised, indent=1) + "\n")

    @staticmethod
    def load(path: str | Path, alerts=None) -> "StatLogger":
        sl = StatLogger(alerts)
        if Path(path).exists():
            for k, v in json.loads(Path(path).read_text()).items():
                sl.entries[k] = LogEntry(k, v)
        return sl


def n50(lengths) -> int:
    """N50 of a length collection (ReportAssemblyStats' N-stat)."""
    import numpy as np

    ls = np.sort(np.asarray(lengths))[::-1]
    if ls.size == 0:
        return 0
    half = ls.sum() / 2
    return int(ls[np.searchsorted(np.cumsum(ls), half)])
