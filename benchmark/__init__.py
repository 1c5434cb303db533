"""The benchmark of supernova_tpu_torch on one H100: see BENCHMARK.json and
PERF.md.  STARTED is when the process began importing it: a run's set-up
counts from here, imports included."""
import time

STARTED = time.perf_counter()
