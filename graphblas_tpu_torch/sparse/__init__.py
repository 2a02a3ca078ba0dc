"""Sparse containers and the triangle-counting engines (PyTorch)."""

from .bitdot import (BitdotPlan, PackLevel, bitdot_counts,
                     bitdot_popcount, build_bitdot_plan,
                     masked_pair_counts_auto)
from .container import CsrMatrix, csr_from_coo, default_device
from .cuda_window import tricount_band_partials, window_count_partials
from .tri import (csr_filter_lanes, csr_tril, csr_triu, masked_pair_counts,
                  tricount_auto, tricount_device, tricount_esc,
                  tricount_prep_csr)
from .window import (BandPlan, WindowPlan, build_band_plan,
                     build_window_plan, tricount_window,
                     window_masked_count_sum)

__all__ = [
    "CsrMatrix", "csr_from_coo", "default_device",
    "BandPlan", "WindowPlan", "build_band_plan", "build_window_plan",
    "tricount_window", "window_masked_count_sum",
    "tricount_band_partials", "window_count_partials",
    "BitdotPlan", "PackLevel", "build_bitdot_plan", "bitdot_counts",
    "bitdot_popcount", "masked_pair_counts_auto",
    "masked_pair_counts", "tricount_esc", "tricount_device",
    "tricount_auto", "tricount_prep_csr", "csr_filter_lanes", "csr_tril",
    "csr_triu",
]
