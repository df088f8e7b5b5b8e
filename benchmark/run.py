"""The benchmark of bdlz_tpu_torch, the PyTorch and CUDA port: one run of one
cell of BENCHMARK.json, from the root of a checkout.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>
"""
import pathlib
import sys
import time

T_START = time.perf_counter()

if __name__ == "__main__":
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    from benchmark.harness.main import main

    main(t_start=T_START)
