"""``python -m repro_torch.analysis``: see repro_torch.analysis.report.

No XLA flags to set: the TP combinations of the contracts run in spawned
gloo rank groups (``launch.mesh.spawn_tp``), one per degree, so the
report is the same on a laptop, in CI and on the card's host."""
import sys

from repro_torch.analysis.report import main

if __name__ == "__main__":
    sys.exit(main())
