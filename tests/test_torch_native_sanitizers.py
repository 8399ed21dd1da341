"""ASan/UBSan sweep of the port's copy of the C++ replay engine.

The self-test driver replays a synthetic insertion stream through every
phase (build, prune, expand, extend both ways, verbose print) under the
address and undefined-behaviour sanitizers.  The binary is built into
``genome_assembly_tpu_torch/build/``, named by the hash of its sources
and flags.
"""

import subprocess

from genome_assembly_tpu_torch.native import build


def test_replay_engine_under_sanitizers():
    binary = build.build_sanitizer_selftest()
    assert binary.parent == build.BUILD_DIR
    proc = subprocess.run(
        [str(binary)], capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("ok "), proc.stdout
