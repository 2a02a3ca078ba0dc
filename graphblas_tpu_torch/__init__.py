"""graphblas_tpu_torch: the PyTorch / CUDA port of graphblas_tpu.

The JAX package ``graphblas_tpu`` is the reference; this package keeps
its module paths and function names so each counterpart is easy to find,
and imports no JAX.  The slices so far:

* masked structural SpGEMM triangle counting on CSR containers
  (SandiaDot ``ntri = sum (L·U') .* L``) with three hand-written CUDA
  kernels for Hopper: the band-ring and window-count panel kernels
  (:mod:`sparse.cuda_window`) and the bitmap popcount pass
  (:mod:`sparse.bitdot`);
* the masked valued product ``mxm(C, M, None, semiring, A, B)`` on CSR
  containers for any builtin semiring (the algebra in :mod:`core`, the
  ESC engine, the sparse accum/mask epilogue, and the value-panel engine
  :mod:`sparse.valdot` with its hand-written gather-dot kernels, over
  dense panels and over compacted panel rows);
* SpMV: ``mxv``/``vxm`` on ``Vector`` outputs with CSR, CSC or bitmap
  matrices (:mod:`sparse.spmv`, the BSR tile kernel of
  :mod:`sparse.cuda_spmv`) and the whole-loop ``bfs_csr`` /
  ``pagerank_csr``;
* ``mxm`` into a bitmap ``Matrix`` for every builtin semiring: the dense
  engines of ``semiring_mm`` with the hand-written tropical kernel for
  FP32 MIN_PLUS, MAX_PLUS, MIN_MAX and MAX_MIN (:mod:`sparse.cuda_tropical`),
  the SpMM fast path for a CSR/CSC ``A`` (:mod:`sparse.spmm`), and the
  window masked-product kernel ``window_masked_mm_pallas``
  (:mod:`sparse.cuda_window`);
* the BSR tile engine, k-truss on the counting engines and the gather
  probes;
* the rest of the algebra (unary and select ops, :mod:`core.options`),
  ``eWiseAdd``/``eWiseMult``/``apply``/``select``, ``reduce``,
  ``transpose``/``kron`` on bitmap, CSR and CSC containers
  (:mod:`ops.ewise`, :mod:`sparse.ewise`, :mod:`ops.reduce`,
  :mod:`ops.transpose`), and the counting models built on them
  (:mod:`models`: ``tricount``'s six methods, ``ktruss``,
  ``allktruss``, ``kron_generate``);
* pending tuples (``setElement``/``wait`` on every container, with the
  element accessors, ``resize`` and ``clear``), ``extract`` and
  ``assign`` in all their forms (:mod:`ops.extract`, :mod:`ops.assign`,
  :mod:`sparse.assign`), and the graph models ``bfs5m``/``bfs6``/
  ``bfs_jit``, ``mis``, ``dpagerank``/``ipagerank``/``pagerank_jit``;
* the hypersparse containers ``HyperMatrix``, ``HyperCscMatrix`` and
  ``SparseVec`` (dimension up to 2^60) with their pair-key engines
  (:mod:`sparse.hyper`, :mod:`sparse.hyper_assign`), as outputs of every
  operation, and import/export (:mod:`core.io_export`);
* user-defined struct types (``Type.udt``, values as dicts of tensors,
  :mod:`utils.tree`) over every container and engine, with the UDT
  PageRank ``dpagerank2``/``dpagerank2_csr``, and the complex types
  ``FC32``/``FC64``;
* the user-facing layer: the ``GrB_*``/``GxB_*`` facade (:mod:`grb`)
  and the m4 example objects (:mod:`user_objects`), ``fprint`` and
  ``check`` (:mod:`core.printing`), triplet/MatrixMarket IO and ``.npz``
  checkpoints (:mod:`io`), ``isequal``, timers and fault injection
  (:mod:`utils`), and the single-card demos (:mod:`demos`, run as
  ``python -m graphblas_tpu_torch.demos.<name>``);
* the distributed layer (:mod:`parallel`, imported on its own): rank
  meshes on ``torch.distributed`` (one process per rank; NCCL, or gloo
  with the collectives staged through host memory), sharded bitmap and
  CSR containers, the ring SpGEMM, the distributed graph models and the
  collective census.

The kernels are built with ``nvcc`` on first use, never at import.

Tensors live on the CUDA card by default: a constructor called without
``device`` on a machine with no card raises; pass ``device="cpu"`` to
work on the CPU.  On CPU tensors each kernel wrapper runs the kernel's
plain PyTorch version.
"""

from . import convert, models
from .core.errors import (DimensionMismatch, DomainMismatch,
                          GraphBLASError, IndexOutOfBounds, Info,
                          InvalidValue)
from .core.descriptor import (NULL_DESC, REPLACE, RST, RT, SCMP, ST,
                              TRAN0, TRAN1, TT, Descriptor)
from .core.matrix import Matrix, Vector
from .core.monoids import MONOIDS, Monoid, monoid, monoid_new
from .core.ops import (BinaryOp, SelectOp, UnaryOp, binary, binary_op,
                       select as selectop, unary, unary_op)
from .core.printing import COMPLETE, SHORT, SILENT, SUMMARY, check, fprint
from .core.io_export import (export_csc, export_csr, export_hyper_csc,
                             export_hyper_csr, export_vector, import_csc,
                             import_csr, import_hyper_csc, import_hyper_csr,
                             import_vector)
from .core.options import (BLOCKING, BY_COL, BY_ROW, NONBLOCKING, Options,
                           get_option, global_options, init, set_option)
from .core.resolve import UnsupportedOp
from .core.semirings import SEMIRINGS, Semiring, semiring, semiring_new
from .core.semirings import lookup as semiring_lookup
from .core.types import (BOOL, BUILTIN_TYPES, FC32, FC64, FP32, FP64, INT8,
                         INT16, INT32, INT64, UINT8, UINT16, UINT32, UINT64,
                         Type, type_of_dtype)
from .models.generate import wathen_coo
from .models.rmat import rmat_edges, symmetrize_pattern
from .utils.indices import ALL
from .ops.assign import (assign, assign_scalar, assign_vector, col_assign,
                         row_assign, subassign, subassign_scalar,
                         subassign_vector)
from .ops.containers import UnsupportedContainer
from .ops.extract import extract, extract_col, extract_vector
from .ops.flopcount import last_axb_method, jax_engine_name
from .ops.ewise import apply, eWiseAdd, eWiseMult, select
from .ops.mxm import mxm, mxv, semiring_mm, vxm
from .ops.reduce import reduce, reduce_to_scalar, reduce_to_vector
from .ops.transpose import kron, transpose
from .sparse import *  # noqa: F401,F403
from .sparse import __all__ as _sparse_all

__all__ = [
    "convert", "DimensionMismatch", "DomainMismatch", "GraphBLASError",
    "IndexOutOfBounds", "Info", "InvalidValue",
    "BOOL", "FP32", "FP64", "INT8", "INT16", "INT32", "INT64", "UINT8",
    "UINT16", "UINT32", "UINT64", "FC32", "FC64", "Type", "type_of_dtype",
    "BUILTIN_TYPES", "Semiring", "SEMIRINGS", "semiring_lookup",
    "semiring_new", "fprint", "check", "SILENT", "SUMMARY", "SHORT",
    "COMPLETE",
    "Descriptor", "NULL_DESC", "REPLACE", "SCMP", "TRAN0", "TRAN1", "RT",
    "ST", "RST", "TT", "Matrix", "Vector", "Monoid", "monoid", "MONOIDS",
    "monoid_new", "UnaryOp", "BinaryOp", "SelectOp", "unary", "binary",
    "selectop", "binary_op", "unary_op", "semiring",
    "Options", "global_options", "init", "set_option", "get_option",
    "BLOCKING", "NONBLOCKING", "BY_ROW", "BY_COL", "import_csr",
    "import_csc", "import_hyper_csr", "import_hyper_csc", "export_csr",
    "export_hyper_csr", "export_hyper_csc", "export_csc",
    "import_vector", "export_vector", "UnsupportedOp", "UnsupportedContainer", "mxm", "mxv", "vxm",
    "semiring_mm", "eWiseAdd", "eWiseMult", "apply", "select", "reduce",
    "reduce_to_vector", "reduce_to_scalar", "transpose", "kron", "models",
    "ALL", "extract", "extract_vector", "extract_col", "assign",
    "subassign", "assign_scalar", "subassign_scalar", "assign_vector",
    "subassign_vector", "row_assign", "col_assign",
    "wathen_coo", "rmat_edges", "symmetrize_pattern",
    "jax_engine_name", "last_axb_method", *_sparse_all,
]
