"""The benchmark's CPU tests: the harness, the reference against the
port at a tiny size, the control and the planted faults.  Run from the
checkout's root: ``python -m pytest benchmark/tests -q``."""
import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for path in (BENCH, ROOT):
    if path not in sys.path:
        sys.path.insert(0, path)


@pytest.fixture(scope="session", autouse=True)
def _cpu_tables():
    """The uplift table loaded without a card."""
    import torch
    from lumo_tpu_torch.color import uplift
    torch.set_num_threads(min(4, os.cpu_count() or 1))
    uplift.table(device="cpu")


def tiny(workload, res=16, subdiv=2):
    """A cell of BENCHMARK.json cut to a rehearsal's size."""
    from rehearse import tiny_cell
    return tiny_cell(workload, res, subdiv)
