"""The paper's own workload: the R-MAT micro-benchmark suite x N sweep
(N = 1..128), plus the SuiteSparse-analogue selection benchmark; counterpart
of ``repro.configs.paper_spmm``.  Read by benchmarks, not by the models."""
import dataclasses


@dataclasses.dataclass(frozen=True)
class PaperSpmmConfig:
    n_sweep: tuple = (1, 2, 4, 8, 16, 32, 64, 128)
    tile: int = 512
    seed: int = 0


CONFIG = PaperSpmmConfig()
