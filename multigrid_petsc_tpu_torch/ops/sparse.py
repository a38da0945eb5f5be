"""Explicit sparse operator backend: CSR assembly and the level operator
in its three storage forms (PyTorch counterpart of
``multigrid_petsc_tpu/ops/sparse.py`` and ``dia_from_csr`` of
``multigrid_petsc_tpu/ops/pallas/spmv_dia.py``).

The level operator, including a merged level's R A_f / A_f P coupling
blocks, is assembled into CSR on the host by the port's own copy of the
C++ engine (``csrc/csr_assemble.cpp``, built with the host compiler at
first use; reference: src/solver.c:185-556), then converted, in torch on
the level's device, into the form its shape allows:

  ``"stencil"``  one grid whose diagonals are {0, +-1, +-nx} with no entry
                 wrapping across a grid row: five (ny, nx) coefficient
                 fields, applied by K8 (``stencil_kernel.
                 apply_stencil5_field`` / ``residual5_field``);
  ``"dia"``      any other matrix with at most 16 distinct diagonals (the
                 grid-diagonal A1 of a merged level has 5 + 2(G - 1)):
                 DIA storage, applied by K16 (``spmv_dia_kernel.dia_spmv``);
  ``"ell"``      the rest (coupling blocks): ELL storage, applied as a
                 torch gather and a row sum.

This is the JAX package's route on the TPU.  The CSR is assembled in
f64; the level's values are stored in its dtype (bf16 through f32, as
JAX's ``astype``).  K8 takes f32 and bf16 fields (bf16: f32 sums, each
output rounded once), K16 f32; a float64 operator is ELL by rule (the
JAX package applies ELL to f64 too), and a bf16 one in DIA form (a merged
level's A1, whose K16 is not built in bf16) raises.  ``form`` says which
route a level took.  A level state is one (ny, nx) tensor for a
single-grid level and a tuple of per-grid tensors for a merged level;
``apply`` and ``residual`` return the same kind.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from multigrid_petsc_tpu_torch.hierarchy import grid_interior
from multigrid_petsc_tpu_torch.ops.cuda import spmv_dia_kernel as dia_k
from multigrid_petsc_tpu_torch.ops.cuda import stencil_kernel as sk
from multigrid_petsc_tpu_torch.ops.cuda._build import load_assembler
from multigrid_petsc_tpu_torch.ops.norms import flatten, tree_map, unflatten
from multigrid_petsc_tpu_torch.ops.stencil import Stencil5
from multigrid_petsc_tpu_torch.utils.config import not_ported

MAX_DIAGS = dia_k.MAX_DIAGS


def assemble_level_csr(npts: int, mesh_type: int, gids: tuple[int, ...],
                       include_diag: bool = True,
                       include_couplings: bool = True):
    """Host CSR (indptr int64, indices int32, data f64) of the level
    operator over grids ``gids``: A, or A1 (no couplings) or A2 (no
    diagonal blocks).  A counting pass sizes the arrays exactly."""
    lib = load_assembler()
    gids_arr = (ctypes.c_int * len(gids))(*gids)
    rows = lib.level_rows(npts, gids_arr, len(gids))
    args = (npts, int(mesh_type), gids_arr, len(gids), int(include_diag),
            int(include_couplings))
    nnz = lib.assemble_level(*args, None, None, None, 0)
    if nnz < 0:
        raise RuntimeError(f"CSR assembly failed (code {nnz})")
    indptr = np.zeros(rows + 1, dtype=np.int64)
    indices = np.empty(nnz, dtype=np.int32)
    data = np.empty(nnz, dtype=np.float64)
    got = lib.assemble_level(*args, indptr.ctypes.data, indices.ctypes.data,
                             data.ctypes.data, nnz)
    if got != nnz:
        raise RuntimeError(f"CSR assembly failed (code {got}, counted {nnz})")
    return indptr, indices, data


def _as_tensors(indptr, indices, data, device):
    device = torch.device(device)
    return (torch.as_tensor(np.asarray(indptr), dtype=torch.int64,
                            device=device),
            torch.as_tensor(np.asarray(indices), dtype=torch.int32,
                            device=device),
            torch.as_tensor(data, device=device))


def _row_of(indptr: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(row of every entry, row widths)."""
    widths = indptr[1:] - indptr[:-1]
    rows = torch.arange(widths.shape[0], dtype=torch.int32,
                        device=indptr.device)
    return torch.repeat_interleave(rows, widths), widths


def _diagonals(indptr, indices):
    """(sorted distinct offsets col - row, each entry's offset index, each
    entry's row)."""
    r_of, _ = _row_of(indptr)
    offs = indices - r_of
    uniq, k_of = torch.unique(offs, sorted=True, return_inverse=True)
    return uniq, k_of, r_of


def _stored(data: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The f64 values in ``dtype``; bf16 through f32, as JAX's ``astype``
    rounds them."""
    if dtype == torch.bfloat16:
        data = data.to(torch.float32)
    return data.to(dtype)


def _dia_vals(uniq, k_of, r_of, data, rows, dtype):
    vals = torch.zeros((uniq.shape[0], rows), dtype=dtype, device=data.device)
    vals.view(-1)[k_of * rows + r_of] = _stored(data, dtype)
    return vals


def dia_from_csr(indptr, indices, data, max_diags: int = MAX_DIAGS, *,
                 device="cpu", dtype=torch.float64):
    """(offsets, vals): DIA form of a CSR matrix, ``vals[k, r]`` =
    A[r, r + offsets[k]] (0 where absent).  Raises ValueError past
    ``max_diags`` distinct diagonals, as the JAX function does."""
    indptr, indices, data = _as_tensors(indptr, indices, data, device)
    uniq, k_of, r_of = _diagonals(indptr, indices)
    if uniq.shape[0] > max_diags:
        raise ValueError(f"{uniq.shape[0]} distinct diagonals > {max_diags}: "
                         f"not DIA-shaped")
    vals = _dia_vals(uniq, k_of, r_of, data, indptr.shape[0] - 1, dtype)
    return tuple(int(d) for d in uniq.tolist()), vals


def csr_to_ell(indptr, indices, data, *, device="cpu",
               dtype=torch.float64):
    """(vals, cols), each (rows, K) with K the widest row: CSR rows padded
    with column 0 and value 0, entries in their CSR order."""
    indptr, indices, data = _as_tensors(indptr, indices, data, device)
    return _ell(indptr, indices, data, dtype)


def _ell(indptr, indices, data, dtype):
    r_of, widths = _row_of(indptr)
    rows = widths.shape[0]
    k = int(widths.max()) if rows else 0
    pos = (torch.arange(indices.shape[0], device=indices.device)
           - torch.repeat_interleave(indptr[:-1], widths))
    flat = r_of.to(torch.int64) * k + pos
    cols = torch.zeros((rows, k), dtype=torch.int32, device=indices.device)
    vals = torch.zeros((rows, k), dtype=dtype, device=indices.device)
    cols.view(-1)[flat] = indices
    vals.view(-1)[flat] = _stored(data, dtype)
    return vals, cols


def ell_spmv(vals: torch.Tensor, cols: torch.Tensor, x: torch.Tensor):
    """y = A x in ELL storage: a gather of x and a row sum."""
    xg = torch.index_select(x, 0, cols.reshape(-1)).reshape(cols.shape)
    return torch.sum(vals * xg, dim=1)


class SparseLevelOp:
    """One level's assembled operator on one device, in the form its
    shape allows (see the module docstring).  Only that form's storage is
    kept."""

    def __init__(self, indptr, indices, data, shapes, *, device, dtype):
        self.shapes = [tuple(s) for s in shapes]
        self.rows = sum(ny * nx for ny, nx in self.shapes)
        if len(indptr) - 1 != self.rows:
            raise ValueError(f"CSR has {len(indptr) - 1} rows, the grids "
                             f"{self.shapes} {self.rows}")
        self.nnz = len(indices)
        self.stencil = None   # "stencil": Stencil5 of (ny, nx) fields
        self.dia = None       # "dia": (offsets, vals (K, rows))
        self.ell = None       # "ell": (vals, cols), each (rows, K)
        ip, ind, dat = _as_tensors(indptr, indices, data, device)
        self.form = "ell"
        if dtype != torch.float64:
            uniq, k_of, r_of = _diagonals(ip, ind)
            if uniq.shape[0] <= MAX_DIAGS:
                offsets = tuple(int(d) for d in uniq.tolist())
                vals = _dia_vals(uniq, k_of, r_of, dat, self.rows, dtype)
                del k_of, r_of
                self.stencil = self._stencil_form(offsets, vals)
                if self.stencil is None:
                    if dtype == torch.bfloat16:
                        raise not_ported(
                            "a bf16 operator in DIA form (K16 in bf16, a "
                            "merged level's A1)",
                            "precision, bf16 merged grids")
                    self.form, self.dia = "dia", (offsets, vals)
                else:
                    self.form = "stencil"
                del vals
        if self.form == "ell":
            self.ell = _ell(ip, ind, dat, dtype)

    def _stencil_form(self, offsets, vals):
        """The five (ny, nx) fields when one grid's diagonals are the
        5-point pattern with no flat +-1 entry wrapping across a grid row
        (the JAX package's rule), else None."""
        if len(self.shapes) != 1:
            return None
        ny, nx = self.shapes[0]
        pattern = {-nx: "cs", -1: "cw", 0: "cc", 1: "ce", nx: "cn"}
        if not set(offsets) <= set(pattern):
            return None
        fields = {name: torch.zeros((ny, nx), dtype=vals.dtype,
                                    device=vals.device)
                  for name in pattern.values()}
        for d, row in zip(offsets, vals):
            fields[pattern[d]] = row.reshape(ny, nx)
        if bool(fields["ce"][:, -1:].any()) or bool(fields["cw"][:, :1].any()):
            return None
        return Stencil5(**{k: v.contiguous() for k, v in fields.items()})

    @classmethod
    def assemble(cls, npts: int, mesh_type: int, gids: tuple[int, ...], *,
                 device, dtype, include_diag: bool = True,
                 include_couplings: bool = True) -> "SparseLevelOp":
        """Assemble A (or A1 / A2) of the level over grids ``gids``."""
        csr = assemble_level_csr(npts, mesh_type, tuple(gids), include_diag,
                                 include_couplings)
        shapes = [(grid_interior(npts, g),) * 2 for g in gids]
        return cls(*csr, shapes, device=device, dtype=dtype)

    @classmethod
    def from_csr(cls, indptr, indices, data, shapes, device,
                 dtype) -> "SparseLevelOp":
        """The operator of a given host CSR triple (e.g. the JAX package's
        ``assemble_level_csr``), so two implementations apply one
        matrix."""
        return cls(indptr, indices, data, shapes, device=device, dtype=dtype)

    def apply(self, state):
        """A x (a tensor for one grid, a tuple for several)."""
        if self.form == "stencil":
            return sk.apply_stencil5_field(self.stencil, state)
        x = flatten(state)
        if self.form == "dia":
            y = dia_k.dia_spmv(self.dia[0], self.dia[1], x)
        else:
            y = ell_spmv(*self.ell, x)
        return unflatten(y, self.shapes)

    def residual(self, b, u):
        """b - A u (K8's residual mode on the stencil form)."""
        if self.form == "stencil":
            return sk.residual5_field(self.stencil, b, u)
        return tree_map(lambda bk, ak: bk - ak, b, self.apply(u))
