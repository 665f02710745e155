"""The paper's own workload: distributed sort of 1B keys on up to 52
machines (PGX.D experimental setup, Table I). The port's copy of
``repro/configs/paper_sort.py`` (plain data), over the port's own
``core/splitters.SortConfig``; the sort itself is ``repro_torch.core``.
"""
import dataclasses

from repro_torch.core.splitters import SortConfig


@dataclasses.dataclass(frozen=True)
class PaperSortConfig:
    total_elements: int = 1_000_000_000  # paper: 1B keys
    processors: tuple = (8, 16, 32, 52)  # paper Fig. 5/6 x-axis
    threads_per_proc: int = 32
    distributions: tuple = ("uniform", "normal", "right_skewed", "exponential")
    sort: SortConfig = SortConfig()  # 64KB buffer rule, paper defaults


CONFIG = PaperSortConfig()
