"""Sparse containers, the triangle-counting and k-truss engines, the
masked SpGEMM engines (the edge-centric bitpacked counts and the BSR
tile engine with its kernel), the SpMV engines and the whole-loop graph
algorithms, the sparse extract/assign forms and the hypersparse
containers with their engines (PyTorch); the SpMM engine (:mod:`spmm`) and the tropical
kernel (:mod:`cuda_tropical`) are reached through ``mxm``, as in the JAX
package."""

from .algorithms import bfs_csr, pagerank_csr
from .assign import (csr_assign, csr_assign_scalar, csr_extract,
                     csr_subassign, csr_subassign_scalar, csr_subref)
from .bitdot import (BitdotPlan, CompactRows, PackLevel, bitdot_counts,
                     bitdot_popcount, build_bitdot_plan, compact_rows,
                     masked_pair_counts_auto)
from .bitpack import pack_pattern, pack_rows, popcount, words_for
from .bsr import (TilePattern, bsr_masked_count, tile_matrix, tile_pattern,
                  tile_pattern_from_coo, tricount_bsr)
from .container import CscMatrix, CsrMatrix, csr_from_coo, default_device
from .cuda_bsr import (bsr_masked_count_pallas, bsr_masked_mm_pallas,
                       masked_mxm, tricount_bsr_pallas)
from .cuda_spmv import bsr_spmv, bsr_spmv_ok, bsr_spmv_plan
from .cuda_window import (tricount_band_partials, window_count_partials,
                          window_masked_mm_pallas)
from .esc import csr_spgemm
from .hyper import (GxB_ALWAYS_HYPER, GxB_HYPER_DEFAULT, GxB_INDEX_MAX,
                    GxB_NEVER_HYPER, HyperMatrix, hyper_apply, hyper_conform,
                    hyper_ewise, hyper_from_coo, hyper_mxv,
                    hyper_reduce_scalar, hyper_reduce_vector, hyper_select,
                    hyper_spgemm, hyper_transpose, nvec_nonempty)
from .hyper_assign import (hyper_assign, hyper_extract, hyper_filter_lanes,
                           hyper_subassign, hyper_subref)
from .hyper_csc import HyperCscMatrix
from .mask import csr_accum_mask, csr_clear
from .spgemm import (edge_intersection_counts, ktruss_sparse,
                     masked_spgemm_counts, tricount_sparse)
from .spmv import csr_mxv, csr_vxm
from .tri import (allktruss_esc, csr_filter_lanes, csr_tril, csr_triu,
                  ktruss_esc, masked_pair_counts, tricount_auto,
                  tricount_device, tricount_esc, tricount_prep_csr)
from .vector import SparseVec
from .valdot import (ValdotPlan, build_valdot_plan, valdot_gatherdot,
                     valdot_gatherdot_rows, valdot_masked_spgemm)
from .window import (BandPlan, TileSchedule, WindowPlan, band_schedule,
                     build_band_plan, build_window_plan, tricount_window,
                     window_masked_count_sum, window_masked_mm,
                     window_schedule)

__all__ = [
    "CsrMatrix", "CscMatrix", "csr_from_coo", "default_device",
    "BandPlan", "WindowPlan", "build_band_plan", "build_window_plan",
    "tricount_window", "window_masked_count_sum", "window_masked_mm",
    "TileSchedule", "band_schedule", "window_schedule",
    "tricount_band_partials", "window_count_partials",
    "window_masked_mm_pallas",
    "BitdotPlan", "PackLevel", "build_bitdot_plan", "bitdot_counts",
    "bitdot_popcount", "CompactRows", "compact_rows",
    "masked_pair_counts_auto",
    "masked_pair_counts", "tricount_esc", "tricount_device",
    "tricount_auto", "tricount_prep_csr", "csr_filter_lanes", "csr_tril",
    "csr_triu", "csr_spgemm", "csr_accum_mask", "csr_clear",
    "ValdotPlan", "build_valdot_plan", "valdot_gatherdot",
    "valdot_gatherdot_rows", "valdot_masked_spgemm", "csr_mxv",
    "csr_vxm", "bsr_spmv",
    "bsr_spmv_ok", "bsr_spmv_plan", "bfs_csr", "pagerank_csr",
    "pack_pattern", "pack_rows", "popcount", "words_for",
    "csr_subref", "csr_extract", "csr_assign", "csr_subassign",
    "csr_assign_scalar", "csr_subassign_scalar", "edge_intersection_counts",
    "masked_spgemm_counts", "tricount_sparse", "ktruss_sparse",
    "tile_pattern", "tile_pattern_from_coo", "tile_matrix",
    "bsr_masked_count", "tricount_bsr", "TilePattern",
    "bsr_masked_mm_pallas", "bsr_masked_count_pallas",
    "tricount_bsr_pallas", "masked_mxm", "ktruss_esc", "allktruss_esc",
    "HyperMatrix", "HyperCscMatrix", "hyper_from_coo", "hyper_spgemm",
    "hyper_ewise", "hyper_mxv", "hyper_reduce_scalar", "hyper_reduce_vector",
    "hyper_apply", "hyper_select", "hyper_transpose", "hyper_conform",
    "nvec_nonempty", "GxB_INDEX_MAX", "GxB_HYPER_DEFAULT",
    "GxB_ALWAYS_HYPER", "GxB_NEVER_HYPER", "hyper_subref", "hyper_extract",
    "hyper_assign", "hyper_subassign", "hyper_filter_lanes", "SparseVec",
]
