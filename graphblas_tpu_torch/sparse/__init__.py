"""Sparse containers, the triangle-counting and k-truss engines, the
masked SpGEMM engines (the edge-centric bitpacked counts and the BSR
tile engine with its kernel), the SpMV engines and the whole-loop graph
algorithms (PyTorch); the SpMM engine (:mod:`spmm`) and the tropical
kernel (:mod:`cuda_tropical`) are reached through ``mxm``, as in the JAX
package."""

from .algorithms import bfs_csr, pagerank_csr
from .bitdot import (BitdotPlan, PackLevel, bitdot_counts,
                     bitdot_popcount, build_bitdot_plan,
                     masked_pair_counts_auto)
from .bitpack import pack_pattern, popcount, words_for
from .bsr import (TilePattern, bsr_masked_count, tile_matrix, tile_pattern,
                  tile_pattern_from_coo, tricount_bsr)
from .container import CscMatrix, CsrMatrix, csr_from_coo, default_device
from .cuda_bsr import (bsr_masked_count_pallas, bsr_masked_mm_pallas,
                       masked_mxm, tricount_bsr_pallas)
from .cuda_spmv import bsr_spmv, bsr_spmv_ok, bsr_spmv_plan
from .cuda_window import (tricount_band_partials, window_count_partials,
                          window_masked_mm_pallas)
from .esc import csr_spgemm
from .mask import csr_accum_mask, csr_clear
from .spgemm import (edge_intersection_counts, ktruss_sparse,
                     masked_spgemm_counts, tricount_sparse)
from .spmv import csr_mxv, csr_vxm
from .tri import (allktruss_esc, csr_filter_lanes, csr_tril, csr_triu,
                  ktruss_esc, masked_pair_counts, tricount_auto,
                  tricount_device, tricount_esc, tricount_prep_csr)
from .valdot import (ValdotPlan, build_valdot_plan, valdot_gatherdot,
                     valdot_masked_spgemm)
from .window import (BandPlan, WindowPlan, build_band_plan,
                     build_window_plan, tricount_window,
                     window_masked_count_sum, window_masked_mm)

__all__ = [
    "CsrMatrix", "CscMatrix", "csr_from_coo", "default_device",
    "BandPlan", "WindowPlan", "build_band_plan", "build_window_plan",
    "tricount_window", "window_masked_count_sum", "window_masked_mm",
    "tricount_band_partials", "window_count_partials",
    "window_masked_mm_pallas",
    "BitdotPlan", "PackLevel", "build_bitdot_plan", "bitdot_counts",
    "bitdot_popcount", "masked_pair_counts_auto",
    "masked_pair_counts", "tricount_esc", "tricount_device",
    "tricount_auto", "tricount_prep_csr", "csr_filter_lanes", "csr_tril",
    "csr_triu", "csr_spgemm", "csr_accum_mask", "csr_clear",
    "ValdotPlan", "build_valdot_plan", "valdot_gatherdot",
    "valdot_masked_spgemm", "csr_mxv", "csr_vxm", "bsr_spmv",
    "bsr_spmv_ok", "bsr_spmv_plan", "bfs_csr", "pagerank_csr",
    "pack_pattern", "popcount", "words_for", "edge_intersection_counts",
    "masked_spgemm_counts", "tricount_sparse", "ktruss_sparse",
    "tile_pattern", "tile_pattern_from_coo", "tile_matrix",
    "bsr_masked_count", "tricount_bsr", "TilePattern",
    "bsr_masked_mm_pallas", "bsr_masked_count_pallas",
    "tricount_bsr_pallas", "masked_mxm", "ktruss_esc", "allktruss_esc",
]
