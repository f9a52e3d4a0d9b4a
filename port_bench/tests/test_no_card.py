"""Without a card a run fails and prints no result: it never falls back
to the CPU."""

import os
import subprocess
import sys

from port_bench import harness


def test_a_run_without_a_card_exits_non_zero():
    out = subprocess.run([sys.executable, "-m", "port_bench.run", "--workload",
                          "dsprites_b128_train", "--seed", "3", "--seconds", "1", "--trace", "0"],
                         cwd=harness.REPO, capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode == 2
    assert out.stdout == ""
    assert "CUDA card" in out.stderr
