"""Run one cell of the benchmark of grom_tpu_torch and print its result.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell (BENCHMARK.json ``workloads``) names a configuration
(``benchmark/configs/``) and a traffic mix (``benchmark/traffic/``);
``harness.py`` does the run. The last line on standard output is one JSON
object; a host without the CUDA cards the cell asks for gets no result
and a non-zero exit code.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:]))
