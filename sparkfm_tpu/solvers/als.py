"""ALS (coordinate-descent) solver.

Re-design of the reference's driver-sequential ALS (fm/lib/ALS.scala:15-75):
the reference collects the ENTIRE transposed dataset to the driver
(ALS.scala:34) and runs O(p + k*p) *sequential scalar* coordinate updates per
sweep, patching the residual map e (ALS.scala:194-198) and the q cache
(ALS.scala:60-62) in place. Here the sweep is one jitted program over padded
device arrays:

  * Features are processed in BLOCKS: Jacobi within a block, Gauss-Seidel
    across blocks. After every block the residual e and factor cache q are
    patched EXACTLY (not linearized):

        dq_i  = sum_{j in block} dv_j x_ij                       (sparse matvec)
        de_i  = 1/2 (q_new_i^2 - q_old_i^2)
              - 1/2 sum_{j in block} (v_new_j^2 - v_old_j^2) x_ij^2

    which is the full quadratic change of the factor-f term, so across-block
    semantics are identical to true Gauss-Seidel on block granularity.
  * With block_size=1 the schedule degenerates to the reference's exact
    sequential Gauss-Seidel (the parity test uses this).
  * For one-hot field data, features of the same field never co-occur in an
    example, so within-field Jacobi IS Gauss-Seidel: field-aligned blocks
    give full parallelism with zero staleness.
  * Update rule per coordinate (reference computeTheta, ALS.scala:167-176):
        theta* = (theta * sum(h^2) - sum(e*h)) / (reg + sum(h^2))
    with h = x for linear weights, h = x*(q - x*v) for factors, guarded
    against NaN/Inf/empty columns (reference isUpdatable, ALS.scala:190-192).

The per-coordinate sums Sum(e*h), Sum(h^2) are jax.ops.segment_sum over a
flat transposed (CSC) view — padding entries have x == 0 and contribute
exactly zero to every sum, so no masking is needed anywhere.

ALS optimizes squared loss only (Rendle 2011); classification uses the SGD
solver (the reference never implemented classification training at all).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from sparkfm_tpu.config import ALSConfig, FMConfig, Task
from sparkfm_tpu.data.batching import SparseDataset
from sparkfm_tpu.models.fm import FMParams


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class ALSWorkspace:
    """Device-resident dataset views consumed by the sweep.

    CSC/flat view (column sums):  col_feat/col_row/col_val (nnz,) sorted by
                                  feature (the reference's transposeInput,
                                  DataSet.scala:31-38, without the shuffle)
    block_of_feat: (F,) int32     feature -> block id
    den_w: (F,) f32               Sum_i x_ij^2 per feature (constant per sweep)

    ids/vals (the CSR view) are retired: every sweep quantity — residual
    forward, per-factor q, column sums — derives from the CSC view, so
    the workspace holds ONE nnz-sized copy of the data, not two
    (VERDICT r2 weak #8). The fields remain (always None) for pytree
    stability.
    """

    ids: Optional[jnp.ndarray]
    vals: Optional[jnp.ndarray]
    y: jnp.ndarray
    col_feat: jnp.ndarray
    col_row: jnp.ndarray
    col_val: jnp.ndarray
    block_of_feat: jnp.ndarray
    den_w: jnp.ndarray
    # Example validity (False = padding row added for even sharding). Only
    # the bias update needs it: padded rows have all-zero vals so they
    # contribute exactly zero to every per-feature sum already.
    mask: jnp.ndarray = None
    # Compact-sweep fields (single-device build_workspace only; the
    # sharded builder leaves them None and uses _sweep_impl):
    #   col_rank: (nnz,) dense rank of col_feat among PRESENT features —
    #             sorted, step <= 1: the ops/segsum.segment_colsums
    #             contract.
    #   present:  (Fp,) int32 present feature ids (rank r <-> feature
    #             present[r]); absent features never update.
    # The retired CSR fields ids/vals are REPURPOSED by the compact
    # sweep: ids holds the (L, N) compact RANKS per slot and vals the
    # (L, N) values — per-example sums (q, score, e/q patches) become
    # contiguous column reductions instead of by-example scatter-adds.
    # TRANSPOSED storage: the per-block slice of a slot then runs along
    # the major axis of an (L, N) array instead of the minor axis of an
    # (N, L) one.
    col_rank: Optional[jnp.ndarray] = None
    present: Optional[jnp.ndarray] = None


def build_workspace(ds: SparseDataset, cfg: FMConfig,
                    als_cfg: ALSConfig) -> tuple:
    """Host-side prep: flatten + sort the transposed view, assign blocks.

    Returns (workspace, num_blocks).

    Examples are RE-ORDERED by their slot-0 feature first (ALS is a
    full-batch method: example order has no semantic meaning, only
    float-summation order shifts within tolerance). With slot-aligned
    blocks this makes block 0's CSC run the IDENTITY permutation of
    examples (entries sorted by feature, stable over the example order,
    which now IS slot-0-feature order), so the sweep's e/q gathers for
    that block — half of the per-factor gather bill at L=2 — disappear
    (see slice_identity in :func:`csc_slice_identity`).
    """
    n, l = ds.ids.shape
    f = cfg.num_features
    ex_order = np.argsort(np.asarray(ds.ids[:, 0]), kind="stable")
    ids_s = np.asarray(ds.ids)[ex_order]
    vals_s = np.asarray(ds.vals)[ex_order]
    y_s = np.asarray(ds.y)[ex_order]
    col_feat = ids_s.reshape(-1).astype(np.int32)
    col_row = np.repeat(np.arange(n, dtype=np.int32), l)
    col_val = vals_s.reshape(-1).astype(np.float32)
    order = np.argsort(col_feat, kind="stable")
    col_feat, col_row, col_val = (col_feat[order], col_row[order],
                                  col_val[order])

    if als_cfg.feature_blocks is not None:
        block_of_feat = np.asarray(als_cfg.feature_blocks, np.int32)
        assert block_of_feat.shape == (f,)
        num_blocks = int(block_of_feat.max()) + 1
    else:
        bs = max(1, als_cfg.block_size)
        block_of_feat = (np.arange(f) // bs).astype(np.int32)
        num_blocks = int(block_of_feat.max()) + 1

    den_w = np.zeros((f,), np.float32)
    np.add.at(den_w, col_feat, col_val ** 2)

    # Compact rank space for the factored sweep: dense rank of
    # each sorted CSC entry + the (N, L) CSR view in rank space. Both are
    # free on the host (the sort already happened) and let the sweep
    # stream its per-feature sums (segment_colsums) and row-reduce its
    # per-example sums instead of scatter-adding either.
    boundary = np.empty(col_feat.shape[0], bool)
    boundary[0] = True
    boundary[1:] = col_feat[1:] != col_feat[:-1]
    col_rank = (np.cumsum(boundary) - 1).astype(np.int32)
    present = col_feat[boundary].astype(np.int32)
    rank_of_feat = np.zeros((f,), np.int32)
    rank_of_feat[present] = np.arange(len(present), dtype=np.int32)
    rank_csr = rank_of_feat[ids_s]

    ws = ALSWorkspace(
        ids=jnp.asarray(np.ascontiguousarray(rank_csr.T)),
        vals=jnp.asarray(np.ascontiguousarray(
            vals_s.astype(np.float32).T)),      # (L, N) — see class doc
        y=jnp.asarray(y_s),
        col_feat=jnp.asarray(col_feat), col_row=jnp.asarray(col_row),
        col_val=jnp.asarray(col_val),
        block_of_feat=jnp.asarray(block_of_feat),
        den_w=jnp.asarray(den_w),
        mask=jnp.ones((n,), jnp.float32),
        col_rank=jnp.asarray(col_rank),
        present=jnp.asarray(present))
    return ws, num_blocks


def _guarded_theta(theta, num, den, reg):
    """theta* = (theta*den - num) / (reg + den), kept only if finite and the
    column is non-empty (reference computeTheta + isUpdatable)."""
    new = (theta * den - num) / (reg + den)
    ok = jnp.isfinite(new) & (den > 0)
    return jnp.where(ok, new, theta)


def _sweep_impl(params: FMParams, ws: ALSWorkspace, num_blocks: int,
                num_features: int, reg0: float, reg_w, reg_v,
                use_bias: bool = True, use_linear: bool = True,
                axis_name: Optional[str] = None) -> FMParams:
    """One full coordinate sweep: w0, all w blocks, all (factor, block)s.

    ``reg_w``/``reg_v`` may be scalars or per-feature (F,) vectors (the
    attribute-group capability, reference Metadata.scala:8-29: per-group
    lambdas spread to features by FMConfig.reg_vectors) — _guarded_theta
    is elementwise either way.

    With ``axis_name`` set (sharded mode), examples are sharded over that
    mesh axis: every per-feature reduction is psum'd, parameters stay
    replicated (each shard computes identical theta updates), and residual/q
    patches remain purely local — the collective traffic is one (F,) psum
    per block step, replacing the reference's per-sweep driver collects
    (ALS.scala:34,139).
    """
    F = num_features
    K = params.v.shape[-1]
    allr = ((lambda x: jax.lax.psum(x, axis_name)) if axis_name
            else (lambda x: x))
    mask = ws.mask if ws.mask is not None else jnp.ones_like(ws.y)
    den_w_g = allr(ws.den_w)

    # --- residuals e = yhat - y (fresh each sweep; the reference does the
    # same distributed precompute, ALS.scala:142-144). Computed from the
    # CSC view alone — the workspace holds NO (N, L) CSR copy (VERDICT r2
    # weak #8: CSR + CSC both resident doubled dataset HBM for nothing).
    n_ex = ws.y.shape[0]

    def _col_q(vf):
        return jax.ops.segment_sum(vf[ws.col_feat] * ws.col_val,
                                   ws.col_row, num_segments=n_ex)

    score = jnp.zeros((n_ex,), jnp.float32)
    if use_bias:
        score = score + params.w0
    if use_linear:
        score = score + _col_q(params.w)

    def _factor_score(f_, s):
        vx = params.v[:, f_][ws.col_feat] * ws.col_val
        qf = jax.ops.segment_sum(vx, ws.col_row, num_segments=n_ex)
        sqf = jax.ops.segment_sum(jnp.square(vx), ws.col_row,
                                  num_segments=n_ex)
        return s + 0.5 * (jnp.square(qf) - sqf)

    score = jax.lax.fori_loop(0, K, _factor_score, score)
    e = score - ws.y

    # --- global bias (h == 1 for every valid example; ALS.scala:152-154)
    if use_bias:
        w0_new = _guarded_theta(params.w0, allr(jnp.sum(e * mask)),
                                allr(jnp.sum(mask)), reg0)
        e = e + (w0_new - params.w0)
    else:
        w0_new = params.w0

    # --- linear weights, blocked (h_ij = x_ij; den is constant = den_w)
    def w_block(b, carry):
        w, e = carry
        num = allr(jax.ops.segment_sum(
            e[ws.col_row] * ws.col_val, ws.col_feat,
            num_segments=F, indices_are_sorted=True))
        theta_new = _guarded_theta(w, num, den_w_g, reg_w)
        delta = jnp.where(ws.block_of_feat == b, theta_new - w, 0.0)
        w = w + delta
        # exact residual patch: de_i = sum_j delta_j x_ij (purely local)
        de = jax.ops.segment_sum(delta[ws.col_feat] * ws.col_val, ws.col_row,
                                 num_segments=ws.y.shape[0])
        return (w, e + de)

    if use_linear:
        w_new, e = jax.lax.fori_loop(0, num_blocks, w_block,
                                     (params.w, e))
    else:
        w_new = params.w

    # --- factors: for each factor f, blocked coordinate updates with exact
    # q/e patching (replaces ALS.scala:47-70's sequential loop)
    def factor_body(f, carry):
        v, e = carry
        vf = v[:, f]                                     # (F,)
        # q_i = sum_j v_fj x_ij  (ALS.scala:146-150), from the CSC view
        q = _col_q(vf)

        def v_block(b, carry2):
            vf, q, e = carry2
            h = ws.col_val * (q[ws.col_row] - ws.col_val * vf[ws.col_feat])
            num = allr(jax.ops.segment_sum(
                e[ws.col_row] * h, ws.col_feat,
                num_segments=F, indices_are_sorted=True))
            den = allr(jax.ops.segment_sum(
                h * h, ws.col_feat,
                num_segments=F, indices_are_sorted=True))
            theta_new = _guarded_theta(vf, num, den, reg_v)
            in_block = ws.block_of_feat == b
            delta = jnp.where(in_block, theta_new - vf, 0.0)
            vf_new = vf + delta
            # exact q patch: dq_i = sum_j delta_j x_ij (local)
            dq = jax.ops.segment_sum(delta[ws.col_feat] * ws.col_val,
                                     ws.col_row, num_segments=ws.y.shape[0])
            q_new = q + dq
            # exact e patch (full quadratic delta of factor f's term):
            # de = 1/2 (q_new^2 - q^2) - 1/2 sum_j (v_new^2 - v_old^2) x^2
            dsq = jnp.where(in_block,
                            jnp.square(vf_new) - jnp.square(vf), 0.0)
            de_sq = jax.ops.segment_sum(dsq[ws.col_feat] * ws.col_val ** 2,
                                        ws.col_row,
                                        num_segments=ws.y.shape[0])
            e_new = e + 0.5 * (jnp.square(q_new) - jnp.square(q)) - 0.5 * de_sq
            return (vf_new, q_new, e_new)

        vf, q, e = jax.lax.fori_loop(0, num_blocks, v_block, (vf, q, e))
        return (v.at[:, f].set(vf), e)

    v_new, e = jax.lax.fori_loop(0, K, factor_body, (params.v, e))

    return FMParams(w0=w0_new, w=w_new, v=v_new)


def blocks_are_column_pure(ds: SparseDataset, block_of_feat) -> bool:
    """True iff block b's features appear EXACTLY in CSR column b for
    every example (the slot_blocks layout without multi-hot drift): then
    an e/q patch for block b reads ONE CSR column instead of all L."""
    import numpy as _np
    bof = _np.asarray(block_of_feat)
    ids = _np.asarray(ds.ids)
    vals = _np.asarray(ds.vals)
    L = ids.shape[1]
    if int(bof.max()) + 1 != L:
        return False
    for l in range(L):
        feats = ids[:, l][vals[:, l] != 0]
        if feats.size and not _np.all(bof[feats] == l):
            return False
    return True


def csc_blocks_uniform(ds: SparseDataset, block_of_feat) -> bool:
    """True iff the feature-sorted CSC view is partitioned into
    num_blocks CONTIGUOUS runs of exactly N entries each, run b holding
    precisely block b's entries (block assignment monotone in feature id
    + one entry per example per block — the slot_blocks layout). Then
    every per-block stream in the compact sweep can run on a static
    N-slice of the CSC arrays instead of the full nnz, with pure 1-D
    gathers: 1/L of the gather/stream work and ZERO 2-D temps (the
    (N, 2)-shaped pairing temps of the paired form grow with nnz)."""
    import numpy as _np
    bof = _np.asarray(block_of_feat)
    ids = _np.asarray(ds.ids)
    n, l = ids.shape
    nb = int(bof.max()) + 1
    if nb * n != ids.size:
        return False
    # sort-free structure check (an argsort here is slow on the host at
    # millions of examples): the feature-sorted CSC is partitioned into exact
    # N-runs per block iff (a) block id is monotone in feature id over
    # the features that APPEAR (absent features — zipf tails — are not
    # in the CSC and slot_blocks parks them in block 0, which must not
    # veto) and (b) every block owns exactly N entries. Together they
    # pin run b to [b*N, (b+1)*N).
    occur = _np.bincount(ids.reshape(-1), minlength=len(bof))
    present_blocks = bof[occur > 0]
    if not bool(_np.all(_np.diff(present_blocks) >= 0)):
        return False
    counts = _np.bincount(bof[ids.reshape(-1)], minlength=nb)
    return bool(_np.all(counts == n))


def _compact_ctx(ws: ALSWorkspace, num_blocks: int, num_ranks: int,
                 reg0: float, reg_w, reg_v, use_bias: bool,
                 use_linear: bool, column_pure: bool, csc_uniform: bool,
                 K: int, slice_identity: tuple = ()):
    """Shared machinery of the compact sweep: returns (fwd_w_fn,
    factor_fn) pure functions so the sweep can run as ONE jit
    (:func:`als_sweep_compact`) or as K+1 dispatches
    (:func:`als_sweep_compact_dispatched`, which keeps every dispatch
    short at large N).

    Layout rules (thresholds chosen on earlier hardware; ROADMAP lists
    them for re-measurement):
      * minor-axis (N, 2) paired gathers are used only while their
        padded temp, budgeted at 512 bytes per nnz entry, stays under
        _PAIRED_MINOR_MAX_BYTES (paired_minor).
      * above that, csc_uniform (host-verified: the feature-sorted CSC
        splits into exact N-runs per block) runs every per-block stream
        on a static N-slice with pure 1-D gathers.
      * the batched (N, L, K) forward is replaced by a per-factor fori
        beyond ~1 GiB of gather transients.
    """
    from sparkfm_tpu.ops import segsum as SS

    Fp = num_ranks
    present = ws.present
    rank_csr = ws.ids                                   # (L, N)
    vals_csr = ws.vals                                  # (L, N)
    col_rank = ws.col_rank
    col_row = ws.col_row
    x = ws.col_val
    x2 = x * x
    n_ex = ws.y.shape[0]

    # the paired temps are (nnz, 2) / (L, N, 2) shaped — BOTH tile to
    # 512 bytes per nnz entry, so the guard must scale with nnz = L*N
    # (keying on N alone under-counted by L: a 39-slot dataset at N=5M
    # would have passed at "2.6 GB" while the real eq temp is ~100 GB)
    paired_minor = rank_csr.size * 512 <= _PAIRED_MINOR_MAX_BYTES
    csc_uniform = csc_uniform and not paired_minor
    # With csc_uniform and few blocks, UNROLL the block loops: b becomes
    # a Python int, slices become static, and blocks whose CSC run is
    # the identity permutation (slice_identity, host-verified; block 0
    # by construction after build_workspace's example reorder) skip
    # their e/q gathers entirely — half the per-factor gather bill at
    # L=2, the dominant cost of the large-N sweep.
    unroll = csc_uniform and num_blocks <= 16

    def _ident(b):
        return (unroll and b < len(slice_identity)
                and bool(slice_identity[b]))

    def _csc_slice(arr, b):
        # block b's CSC entries = the contiguous [b*N, (b+1)*N) run
        # (host-verified by csc_blocks_uniform)
        if unroll:                      # b is a Python int: static slice
            return jax.lax.slice_in_dim(arr, b * n_ex, (b + 1) * n_ex)
        return jax.lax.dynamic_slice_in_dim(arr, b * n_ex, n_ex)

    def _patch(arr_c, b):
        """Per-example sum of a compact (Fp,)-indexed quantity over
        block b's slots. column_pure: block b IS CSR column b -> one
        (N,) gather; else the generic (L, N) gather + column sum."""
        if column_pure:
            rb = jax.lax.dynamic_index_in_dim(rank_csr, b, axis=0,
                                              keepdims=False)
            vb = jax.lax.dynamic_index_in_dim(vals_csr, b, axis=0,
                                              keepdims=False)
            return arr_c[rb] * vb, vb
        return jnp.sum(arr_c[rank_csr] * vals_csr, axis=0), None

    def fwd_w_fn(params, interaction=None):
        """Forward + global bias + blocked linear weights.
        Returns (w0_new, w_c, v_c, e, q_all). With ``interaction``
        given (the dispatched path's banked-q forward already summed
        0.5*(q_f^2 - sq_f) over factors), the interaction loop is
        skipped and q_all is None."""
        w_c = params.w[present]
        v_c = params.v[present]                         # (Fp, K)
        den_w_c = ws.den_w[present]
        block_c = ws.block_of_feat[present]
        rw_c = reg_w[present] if jnp.ndim(reg_w) else reg_w
        mask = ws.mask if ws.mask is not None else jnp.ones_like(ws.y)

        # q_all[f] = per-example q for factor f, banked for the factor
        # loop when the batched forward runs (it produces sK for free):
        # q depends only on v[:, f], untouched until factor f runs, so
        # the factor loop can skip its per-factor q0 recompute. Above
        # the batched threshold the bank would be a (K, N) buffer
        # updated by per-factor dynamic row slices, so the large-N fori
        # forward banks nothing and factors recompute q0.
        batched_bytes = rank_csr.size * K * 4
        if interaction is not None:
            score = interaction
            q_all = None
        elif batched_bytes <= (1 << 30):
            v_rows = v_c[rank_csr]                      # (L, N, K)
            vx = v_rows * vals_csr[..., None]
            sK = jnp.sum(vx, axis=0)                    # (N, K)
            ssq = jnp.sum(jnp.square(vx), axis=(0, 2))
            score = 0.5 * (jnp.sum(jnp.square(sK), axis=-1) - ssq)
            q_all = sK.T                                # (K, N)
        else:
            def fwd_f(f, acc):
                vf = jax.lax.dynamic_index_in_dim(v_c, f, axis=1,
                                                  keepdims=False)
                vr = vf[rank_csr] * vals_csr            # (L, N)
                qf = jnp.sum(vr, axis=0)
                sqf = jnp.sum(jnp.square(vr), axis=0)
                return acc + 0.5 * (jnp.square(qf) - sqf)

            score = jax.lax.fori_loop(0, K, fwd_f, jnp.zeros_like(ws.y))
            q_all = None
        if use_linear:
            score = score + jnp.sum(w_c[rank_csr] * vals_csr, axis=0)
        if use_bias:
            score = score + params.w0
        e = score - ws.y

        if use_bias:
            w0_new = _guarded_theta(params.w0, jnp.sum(e * mask),
                                    jnp.sum(mask), reg0)
            e = e + (w0_new - params.w0)
        else:
            w0_new = params.w0

        def w_block(b, carry):
            w_c, e = carry
            if csc_uniform:
                e_csc = e if _ident(b) else e[_csc_slice(col_row, b)]
                num = SS.segment_colsums(
                    [e_csc * _csc_slice(x, b)],
                    _csc_slice(col_rank, b), Fp)[:, 0]
            else:
                num = SS.segment_colsums([e[col_row] * x],
                                         col_rank, Fp)[:, 0]
            theta = _guarded_theta(w_c, num, den_w_c, rw_c)
            delta = jnp.where(block_c == b, theta - w_c, 0.0)
            de, _ = _patch(delta, b)
            return (w_c + delta, e + de)

        if use_linear:
            if unroll:
                carry = (w_c, e)
                for b in range(num_blocks):
                    carry = w_block(b, carry)
                w_c, e = carry
            else:
                w_c, e = jax.lax.fori_loop(0, num_blocks, w_block,
                                           (w_c, e))
        return w0_new, w_c, v_c, e, q_all

    def factor_fn(f, v_c_all, e, q_all):
        """One factor's blocked coordinate updates; returns (v_c, e).
        q_all[f] (when banked by fwd_w_fn — small shapes only, see the
        forward) replaces the per-factor q0 recompute — valid because
        v[:, f] is untouched before this."""
        block_c = ws.block_of_feat[present]
        rv_c = reg_v[present] if jnp.ndim(reg_v) else reg_v
        vf0 = v_c_all[:, f]                             # (Fp,)
        if q_all is None:
            q0 = jnp.sum(vf0[rank_csr] * vals_csr, axis=0)
        elif q_all.ndim == 1:          # dispatched path: this factor's q
            q0 = q_all
        else:
            q0 = jax.lax.dynamic_index_in_dim(q_all, f, axis=0,
                                              keepdims=False)

        def v_block(b, c2):
            vf, q, e = c2
            if csc_uniform:                      # large-N path
                if _ident(b):            # CSC run == example order
                    e_csc, q_csc = e, q
                else:
                    crow_b = _csc_slice(col_row, b)
                    e_csc = e[crow_b]
                    q_csc = q[crow_b]
                xb = _csc_slice(x, b)
                xb2 = xb * xb
                seg_b = _csc_slice(col_rank, b)
            elif paired_minor:
                eq = jnp.stack([e, q], axis=1)[col_row]  # (nnz, 2)
                e_csc = eq[:, 0]
                q_csc = eq[:, 1]
                xb, xb2, seg_b = x, x2, col_rank
            else:
                # no pairing above the padded-temp threshold and no
                # uniform structure: two safe 1-D gathers
                e_csc = e[col_row]
                q_csc = q[col_row]
                xb, xb2, seg_b = x, x2, col_rank
            exq = e_csc * xb * q_csc
            sums = SS.segment_colsums(
                [exq, e_csc * xb2, xb2 * q_csc * q_csc,
                 xb2 * xb * q_csc, xb2 * xb2],
                seg_b, Fp)                              # (Fp, 5)
            num = sums[:, 0] - vf * sums[:, 1]
            den = jnp.maximum(
                sums[:, 2] - 2.0 * vf * sums[:, 3]
                + jnp.square(vf) * sums[:, 4], 0.0)
            theta = _guarded_theta(vf, num, den, rv_c)
            in_b = block_c == b
            delta = jnp.where(in_b, theta - vf, 0.0)
            vf_new = vf + delta
            dsq = jnp.where(in_b, jnp.square(vf_new) - jnp.square(vf),
                            0.0)
            if column_pure:
                rb = jax.lax.dynamic_index_in_dim(rank_csr, b, axis=0,
                                                  keepdims=False)
                vb = jax.lax.dynamic_index_in_dim(vals_csr, b, axis=0,
                                                  keepdims=False)
                if paired_minor:
                    dd = jnp.stack([delta, dsq], axis=1)[rb]    # (N, 2)
                    dq = dd[:, 0] * vb
                    de_sq = dd[:, 1] * jnp.square(vb)
                else:
                    dq = delta[rb] * vb
                    de_sq = dsq[rb] * jnp.square(vb)
            elif paired_minor:
                dd = jnp.stack([delta, dsq], axis=1)[rank_csr]  # (L,N,2)
                dq = jnp.sum(dd[..., 0] * vals_csr, axis=0)
                de_sq = jnp.sum(dd[..., 1] * jnp.square(vals_csr), axis=0)
            else:
                dq = jnp.sum(delta[rank_csr] * vals_csr, axis=0)
                de_sq = jnp.sum(dsq[rank_csr] * jnp.square(vals_csr),
                                axis=0)
            q_new = q + dq
            e_new = (e + 0.5 * (jnp.square(q_new) - jnp.square(q))
                     - 0.5 * de_sq)
            return (vf_new, q_new, e_new)

        if unroll:
            c2 = (vf0, q0, e)
            for b in range(num_blocks):
                c2 = v_block(b, c2)
            vf, q, e = c2
        else:
            vf, q, e = jax.lax.fori_loop(0, num_blocks, v_block,
                                         (vf0, q0, e))
        return v_c_all.at[:, f].set(vf), e

    return fwd_w_fn, factor_fn


# Padded-temp budget for the fast minor-axis paired gathers (tests
# monkeypatch this to force the large-N csc_uniform path on small data)
_PAIRED_MINOR_MAX_BYTES = 3 << 30


def csc_slice_identity(ws: ALSWorkspace, num_blocks: int,
                       n_examples: int) -> tuple:
    """Per-block flags: True iff block b's CSC run is exactly
    col_row[b*N:(b+1)*N] == arange(N) — its e/q "gathers" are then the
    identity and the sweep skips them (build_workspace's example
    reorder makes this true for block 0 by construction on slot-block
    data). Host-side; only meaningful under csc_blocks_uniform."""
    cr = np.asarray(ws.col_row)
    if cr.shape[0] != num_blocks * n_examples:
        return tuple([False] * num_blocks)
    ar = np.arange(n_examples, dtype=cr.dtype)
    return tuple(bool(np.array_equal(
        cr[b * n_examples:(b + 1) * n_examples], ar))
        for b in range(num_blocks))


def _sweep_compact(params: FMParams, ws: ALSWorkspace, num_blocks: int,
                   num_ranks: int, reg0: float, reg_w, reg_v,
                   use_bias: bool = True, use_linear: bool = True,
                   column_pure: bool = False,
                   csc_uniform: bool = False,
                   slice_identity: tuple = ()) -> FMParams:
    """Factored compact sweep — same math as _sweep_impl. Three
    structural changes:

      1. COMPACT RANK SPACE: all per-feature state (w, v, den, reg,
         block ids) lives in (Fp,) present-feature space for the whole
         sweep; params expand back once at the end (absent features
         never change — the den > 0 guard already enforced that).
      2. FACTORED per-feature sums: h = x(q − x·v_f) has v_f CONSTANT
         within a feature column, so Σe·h and Σh² decompose into five
         EXAMPLE-derived streams
             num = Σexq − v·Σex²
             den = Σx²q² − 2v·Σx³q + v²·Σx⁴   (clamped at 0)
         reduced in ONE pass over the sorted CSC view
         (ops/segsum.py::segment_colsums, dense col_rank) — no v
         gather into the stream.
      3. CSC-COLUMN per-example sums: q, the forward score, and every
         e/q patch are (L, N) rank-space gathers + contiguous column
         reductions instead of by-example scatter-adds (ws.ids/ws.vals
         carry the transposed rank-space CSR view).
    """
    K = params.v.shape[-1]
    fwd_w_fn, factor_fn = _compact_ctx(
        ws, num_blocks, num_ranks, reg0, reg_w, reg_v, use_bias,
        use_linear, column_pure, csc_uniform, K, slice_identity)
    w0_new, w_c, v_c, e, q_all = fwd_w_fn(params)

    def body(f, carry):
        v_c, e = carry
        return factor_fn(f, v_c, e, q_all)

    v_c, e = jax.lax.fori_loop(0, K, body, (v_c, e))

    present = ws.present
    w_new = params.w.at[present].set(w_c) if use_linear else params.w
    v_new = params.v.at[present].set(v_c)
    return FMParams(w0=w0_new, w=w_new, v=v_new)


@partial(jax.jit, static_argnames=("num_blocks", "num_ranks", "reg0",
                                   "use_bias", "use_linear",
                                   "column_pure", "csc_uniform", "K",
                                   "slice_identity"))
def _jit_fwd_w(params, ws, num_blocks, num_ranks, reg0, reg_w, reg_v,
               use_bias, use_linear, column_pure, csc_uniform, K,
               slice_identity=(), interaction=None):
    fwd_w_fn, _ = _compact_ctx(ws, num_blocks, num_ranks, reg0, reg_w,
                               reg_v, use_bias, use_linear, column_pure,
                               csc_uniform, K, slice_identity)
    return fwd_w_fn(params, interaction)


@jax.jit
def _jit_compact_v(params, present):
    return params.v[present]                             # (Fp, K)


@partial(jax.jit, donate_argnums=(1,))
def _jit_qf(vf, acc, rank_csr, vals_csr):
    """One factor's forward contribution: returns (q_f, acc + 0.5*(q_f^2
    - sq_f)). The dispatched sweep banks q_f for the factor loop — the
    same (L, N) gather pass previously ran TWICE per factor (forward +
    factor q0 recompute)."""
    vr = vf[rank_csr] * vals_csr                         # (L, N)
    qf = jnp.sum(vr, axis=0)
    sqf = jnp.sum(jnp.square(vr), axis=0)
    return qf, acc + 0.5 * (jnp.square(qf) - sqf)


@partial(jax.jit, static_argnames=("num_blocks", "num_ranks", "reg0",
                                   "use_bias", "use_linear",
                                   "column_pure", "csc_uniform", "K",
                                   "slice_identity"),
         donate_argnums=(1, 2))
def _jit_factor(f, v_c, e, q_all, ws, num_blocks, num_ranks, reg0,
                reg_w, reg_v, use_bias, use_linear, column_pure,
                csc_uniform, K, slice_identity=()):
    _, factor_fn = _compact_ctx(ws, num_blocks, num_ranks, reg0, reg_w,
                                reg_v, use_bias, use_linear, column_pure,
                                csc_uniform, K, slice_identity)
    return factor_fn(f, v_c, e, q_all)


def als_sweep_compact_dispatched(params: FMParams, ws: ALSWorkspace,
                                 num_blocks: int, num_features: int,
                                 num_ranks: int, reg0: float, reg_w,
                                 reg_v, use_bias: bool = True,
                                 use_linear: bool = True,
                                 column_pure: bool = False,
                                 csc_uniform: bool = False,
                                 slice_identity: tuple = ()) -> FMParams:
    """The compact sweep as K+1 dispatches (host factor loop) instead of
    one jit. EXACTLY the update sequence of :func:`als_sweep_compact`
    (same fwd_w_fn / factor_fn; the fori becomes a Python loop), used
    at large N so that no single dispatch runs for the whole sweep.
    Dispatch overhead is K+1 launches, small against multi-second
    factors.
    """
    del num_features
    K = params.v.shape[-1]
    args = (num_blocks, num_ranks, reg0, reg_w, reg_v, use_bias,
            use_linear, column_pure, csc_uniform, K)
    kw = dict(num_blocks=num_blocks, num_ranks=num_ranks, reg0=reg0,
              use_bias=use_bias, use_linear=use_linear,
              column_pure=column_pure, csc_uniform=csc_uniform, K=K,
              slice_identity=slice_identity)
    del args
    # Banked-q forward: K small dispatches compute each factor's q
    # ONCE, keep it as a plain (N,) array (no (K, N) buffer — per-
    # factor row slice/update on one), and accumulate
    # the interaction score; the head dispatch reuses the sum and the
    # factor dispatches skip their q0 recompute (the second of two
    # identical (L, N) gather passes per factor).
    vc_full = _jit_compact_v(params, ws.present)
    acc = jnp.zeros_like(ws.y)
    q_list = []
    for f in range(K):
        qf, acc = _jit_qf(vc_full[:, f], acc, ws.ids, ws.vals)
        q_list.append(qf)
    w0_new, w_c, v_c, e, _ = _jit_fwd_w(params, ws, reg_w=reg_w,
                                        reg_v=reg_v, interaction=acc,
                                        **kw)
    for f in range(K):
        v_c, e = _jit_factor(jnp.int32(f), v_c, e, q_list[f], ws,
                             reg_w=reg_w, reg_v=reg_v, **kw)
    present = ws.present
    w_new = params.w.at[present].set(w_c) if use_linear else params.w
    v_new = params.v.at[present].set(v_c)
    return FMParams(w0=w0_new, w=w_new, v=v_new)


@partial(jax.jit, static_argnames=("num_blocks", "num_features",
                                   "num_ranks", "reg0", "use_bias",
                                   "use_linear", "column_pure",
                                   "csc_uniform", "slice_identity"))
def als_sweep_compact(params: FMParams, ws: ALSWorkspace, num_blocks: int,
                      num_features: int, num_ranks: int, reg0: float,
                      reg_w, reg_v, use_bias: bool = True,
                      use_linear: bool = True,
                      column_pure: bool = False,
                      csc_uniform: bool = False,
                      slice_identity: tuple = ()) -> FMParams:
    """Jitted compact sweep (see _sweep_compact). Requires a workspace
    from :func:`build_workspace` (col_rank/present/CSR rank views).
    column_pure: host-verified via :func:`blocks_are_column_pure`;
    csc_uniform: host-verified via :func:`csc_blocks_uniform` (implies
    per-block streams run on static N-slices of the CSC view). For
    large N use :func:`als_sweep_compact_dispatched` (one short dispatch
    per factor)."""
    del num_features
    if csc_uniform and not column_pure:
        raise ValueError("csc_uniform requires column_pure")
    return _sweep_compact(params, ws, num_blocks, num_ranks, reg0,
                          reg_w, reg_v, use_bias, use_linear,
                          column_pure=column_pure,
                          csc_uniform=csc_uniform,
                          slice_identity=slice_identity)


@partial(jax.jit, static_argnames=("num_blocks", "num_features",
                                   "reg0", "use_bias", "use_linear"))
def als_sweep(params: FMParams, ws: ALSWorkspace, num_blocks: int,
              num_features: int, reg0: float, reg_w, reg_v,
              use_bias: bool = True, use_linear: bool = True) -> FMParams:
    """Single-device jitted sweep (see _sweep_impl). reg_w/reg_v are
    traced (scalar or per-feature vector)."""
    return _sweep_impl(params, ws, num_blocks, num_features, reg0, reg_w,
                       reg_v, use_bias, use_linear, axis_name=None)


def slot_blocks(ds: SparseDataset) -> tuple:
    """Slot-aligned feature blocks: assign each feature to the first CSR
    slot (column position) it appears in. Features sharing a slot never
    co-occur in an example (each example has one feature per slot), so
    within-block Jacobi is exact Gauss-Seidel — stable where contiguous
    arange//block_size blocks can put co-occurring columns together and
    diverge (seen on materialized relational data). Multi-hot features
    that drift across slots (LIST columns, hashed collisions) degrade to
    the same mild within-block Jacobi the contiguous default has.

    Block count = max_nnz (a handful), so the sweep is also maximally
    parallel: one segment-sum pass per slot instead of per 4096 features.
    """
    import numpy as _np
    ids = _np.asarray(ds.ids)
    vals = _np.asarray(ds.vals)
    f = ds.num_features
    blocks = _np.zeros((f,), _np.int32)
    seen = _np.zeros((f,), bool)
    for l in range(ids.shape[1]):
        feats = _np.unique(ids[:, l][vals[:, l] != 0])
        fresh = feats[~seen[feats]]
        blocks[fresh] = l
        seen[fresh] = True
    return tuple(int(b) for b in blocks)


def workspace_hbm_bytes(ds: SparseDataset, cfg: FMConfig) -> int:
    """Upper-bound HBM estimate for one ALS sweep: CSC view (3 x nnz i32/f32),
    y/mask/e/q/score example vectors, params + donated copies, den/num/theta
    feature vectors. The sweep holds no (N, L) CSR copy."""
    nnz = ds.ids.size
    n = ds.num_examples
    f, k = cfg.num_features, cfg.num_factors
    csc = 3 * nnz * 4
    ex_vecs = 6 * n * 4                       # y, mask, e, q, score, scratch
    params = 2 * f * (k + 1) * 4              # params + donation copy
    feat_vecs = 6 * f * 4                     # den_w, num, den, theta, blocks
    return csc + ex_vecs + params + feat_vecs


def _device_hbm_limit() -> int:
    """Accelerator memory budget in bytes; 0 if unknown (no check)."""
    import os
    env = os.environ.get("SPARKFM_HBM_BUDGET")
    if env:
        return int(env)
    try:
        dev = jax.devices()[0]
        if dev.platform == "cpu":
            return 0
        stats = dev.memory_stats() or {}
        return int(stats.get("bytes_limit", 0))
    except Exception:
        return 0


def _check_hbm(ds: SparseDataset, cfg: FMConfig) -> None:
    need = workspace_hbm_bytes(ds, cfg)
    limit = _device_hbm_limit()
    if limit and need > 0.9 * limit:
        raise ValueError(
            f"ALS workspace needs ~{need / 2**30:.1f} GiB but the device "
            f"has {limit / 2**30:.1f} GiB HBM. Options: train on a mesh "
            "(parallel/sharded_als shards the example dimension), use the "
            "block-structure form (solvers/als_bs avoids materializing "
            "relation blocks), or subsample. Set SPARKFM_HBM_BUDGET to "
            "override the detected limit.")


def train_als(cfg: FMConfig, als_cfg: ALSConfig, train: SparseDataset,
              eval_ds: Optional[SparseDataset] = None,
              eval_every: int = 1,
              key: Optional[jax.Array] = None,
              params: Optional[FMParams] = None):
    """Full ALS training loop (reference: FactorizationMachines.learnWith +
    ALS.run, minus the driver round-trips)."""
    from sparkfm_tpu.models import fm as fm_model
    from sparkfm_tpu.training import trainer as _trainer

    if cfg.task != Task.REGRESSION:
        raise ValueError("ALS optimizes squared loss; use SGD for "
                         "classification (the reference never implemented "
                         "classification training either: Task stored but "
                         "unused, impl/FactorizationMachines.scala:12)")
    if cfg.num_fields > 0:
        raise ValueError("ALS supports plain FM (not FFM); use SGD for FFM")

    if params is None:
        params = fm_model.init_params(cfg, key)
    _check_hbm(train, cfg)
    ws, num_blocks = build_workspace(train, cfg, als_cfg)
    # per-feature L2 (scalars broadcast; per-group when cfg.feature_groups)
    reg_w_vec, reg_v_vec = (jnp.asarray(x) for x in cfg.reg_vectors())
    history = []
    import time
    n_examples = 0
    t0 = time.perf_counter()
    n_ranks = int(ws.present.shape[0]) if ws.present is not None else 0
    cpure = bool(n_ranks) and blocks_are_column_pure(
        train, np.asarray(ws.block_of_feat))
    uniform = cpure and csc_blocks_uniform(
        train, np.asarray(ws.block_of_feat))
    ident = (csc_slice_identity(ws, num_blocks, train.ids.shape[0])
             if uniform else ())
    # run the sweep as K+1 dispatches above nnz*K = 4e8 so no single
    # dispatch spans a whole large sweep (exact same update sequence,
    # tests/test_als.py)
    sweep_fn = (als_sweep_compact_dispatched
                if train.ids.size * cfg.num_factors > (4 * 10**8)
                else als_sweep_compact)
    for epoch in range(als_cfg.epochs):
        if n_ranks:
            params = sweep_fn(
                params, ws, num_blocks, cfg.num_features, n_ranks,
                cfg.reg0, reg_w_vec, reg_v_vec, cfg.use_bias,
                cfg.use_linear, column_pure=cpure, csc_uniform=uniform,
                slice_identity=ident)
        else:
            params = als_sweep(params, ws, num_blocks, cfg.num_features,
                               cfg.reg0, reg_w_vec, reg_v_vec,
                               cfg.use_bias, cfg.use_linear)
        n_examples += train.num_examples
        rec = {"epoch": epoch}
        if eval_ds is not None and (epoch % eval_every == 0
                                    or epoch == als_cfg.epochs - 1):
            rec.update({f"eval_{k}": v for k, v in _trainer.evaluate(
                params, cfg, eval_ds).items()})
        history.append(rec)
        if als_cfg.max_seconds and (time.perf_counter() - t0
                                    >= als_cfg.max_seconds):
            # wall-clock budget (the reference's `timeout`, FM.scala:30)
            break
    jax.block_until_ready(params.v)
    eps = n_examples / max(time.perf_counter() - t0, 1e-9)
    return _trainer.TrainResult(params=params, history=history,
                                examples_per_sec=eps)
