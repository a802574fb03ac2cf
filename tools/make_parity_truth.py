"""Refresh the committed parity CPU-truth cache.

Run after any change to the dense-pass semantics (batch_runtime, runtime,
state, ops.tracking, ops.profiles, cacode, synthetic):

    python tools/make_parity_truth.py

Writes ``tools/parity_truth.npz`` (key = hash of SETUP + those sources).
``bench.py``'s parity gate, ``chip_smoke.py`` and ``tools/chip_parity.py``
load this cache instead of re-deriving the truth in a CPU subprocess.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tools.chip_parity import TRUTH_FILE, cpu_truth  # noqa: E402

if __name__ == "__main__":
    cpu_truth(force=True)
    print(f"wrote {TRUTH_FILE} ({os.path.getsize(TRUTH_FILE)} bytes)")
