"""Dry runs: ``python -m repro_torch.launch.dryrun``.

``repro``'s dry run compiles one (arch, shape) cell for a simulated mesh
and reports its memory and flops per device (``repro/launch/dryrun.py``,
``launch/hlo_stats.py``). The port's counterpart, through
``FlopCounterMode`` and the card's memory statistics on the sharded
program, is ROADMAP.md §1 item 11.4; until then this entry point raises
naming it.
"""
from __future__ import annotations

from repro_torch.models import not_ported


def main(argv=None):
    raise not_ported("the dry run (launch/dryrun.py, launch/hlo_stats.py)", "dryrun")


if __name__ == "__main__":
    main()
