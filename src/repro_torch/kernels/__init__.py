"""The port's hand-written Hopper kernels (K1-K11) and the oracles.

Importing this package registers the ``"hopper"`` backend (K1-K10) and the
block-granule ``"bsr"`` backend (K11) in ``repro_torch.core.registry``; the
registry imports it on first resolve of either.  The kernels are built and
loaded at their first launch (``_build.lib``), never at import.
"""
from . import attention, bsr, csc, fused_chain, spmv, vsr
from .attention import (attn_chain_fused, attn_chain_plain, attn_stats_fused,
                        attn_stats_plain, attn_unfused)
from .bsr import spmm_bsr, spmm_bsr_plain
from .csc import spmm_csc, spmm_csc_plain
from .fused_chain import (chain_fused, chain_plain, chain_stats_fused,
                          chain_stats_plain, chain_unfused, sddmm_fused,
                          sddmm_plain)
from .spmv import spmv_vsr, spmv_vsr_fused, spmv_vsr_plain, spmv_vsr_spill_plain
from .vsr import (plan_visits, plan_windows, spmm_as_n_spmv_hopper, spmm_vsr,
                  spmm_vsr_fused, spmm_vsr_plain, spmm_vsr_spill_plain)

#: kernel name -> module whose ``LAUNCHES`` dict counts its launches
KERNEL_MODULES = {"vsr_spmm": vsr, "vsr_spmv": spmv, "csc_spmm": csc,
                  "sddmm": fused_chain, "chain_stats": fused_chain,
                  "chain": fused_chain, "attn_stats": attention,
                  "attn_chain": attention, "bsr_spmm": bsr,
                  "vsr_spmm_spill": vsr, "vsr_spmv_spill": spmv}


def launch_counts() -> dict[str, int]:
    """Launches of each kernel since process start or the last reset."""
    return {name: mod.LAUNCHES[name] for name, mod in KERNEL_MODULES.items()}


def reset_launch_counts() -> None:
    """Set every launch count to 0; a module that keeps counts beyond
    ``LAUNCHES`` resets them in its own ``reset_counts``."""
    for name, mod in KERNEL_MODULES.items():
        mod.LAUNCHES[name] = 0
    for mod in set(KERNEL_MODULES.values()):
        getattr(mod, "reset_counts", lambda: None)()
