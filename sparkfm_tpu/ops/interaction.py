"""Second-order FM interaction ops (pure-JAX reference path).

The math is Rendle's O(k*nnz) identity — the same one the reference uses
per-example on the driver (reference: fm/FMModel.scala:34-63):

    y2(x) = 1/2 * sum_f [ (sum_i v_{f,i} x_i)^2 - sum_i v_{f,i}^2 x_i^2 ]

Here it is batched: inputs are fixed-shape padded CSR batches
(ids: (B, L) int32, vals: (B, L) float32, pad entries have val == 0 which
makes them exact no-ops), and the per-factor loop becomes one vectorized
(B, L, K) contraction that XLA fuses. The hot spots of a train step are
table access (see ops/embedding.py, ops/segsum.py and the solvers'
dedup/fused/sorted paths), not this math. This module is the semantics-defining
baseline those paths are tested against (plus the brute-force O(nnz^2)
pairwise oracle in tests/test_fm_math.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def interaction_from_rows(vx: jnp.ndarray) -> jnp.ndarray:
    """Pairwise interaction given pre-scaled rows.

    Args:
      vx: (B, L, K) array of v_rows * x_vals (already multiplied by feature
        values; padded positions must be exactly zero).

    Returns:
      (B,) interaction term: 1/2 * sum_f [(sum_l vx)^2 - sum_l vx^2].
    """
    s = jnp.sum(vx, axis=1)                       # (B, K)
    sq = jnp.sum(jnp.square(vx), axis=(1, 2))     # (B,)
    return 0.5 * (jnp.sum(jnp.square(s), axis=-1) - sq)


def fm_scores(w0: jnp.ndarray, w: jnp.ndarray, v: jnp.ndarray,
              ids: jnp.ndarray, vals: jnp.ndarray,
              use_bias: bool = True, use_linear: bool = True,
              compute_dtype=jnp.float32) -> jnp.ndarray:
    """Batched FM raw scores: w0 + <w, x> + interaction.

    Args:
      w0: scalar bias.
      w:  (F,) linear weights.
      v:  (F, K) factor table.
      ids:  (B, L) int32 feature ids (padding: any valid id with val == 0).
      vals: (B, L) feature values.

    Returns: (B,) raw scores (apply sigmoid externally for classification).
    """
    vals_c = vals.astype(compute_dtype)
    vx = v[ids].astype(compute_dtype) * vals_c[..., None]   # (B, L, K)
    out = interaction_from_rows(vx)
    if use_linear:
        out = out + jnp.sum(w[ids].astype(compute_dtype) * vals_c, axis=-1)
    if use_bias:
        out = out + w0.astype(compute_dtype)
    return out.astype(jnp.float32)


def fm_scores_from_gathered(w0, w_rows, v_rows, vals,
                            use_bias: bool = True, use_linear: bool = True,
                            compute_dtype=jnp.float32) -> jnp.ndarray:
    """FM scores when the parameter rows are already gathered.

    Used by the sharded path, where the all-to-all gather of active rows is a
    separate (collective) step and by the sparse-update SGD path, which
    differentiates w.r.t. the gathered rows only.

    Args:
      w0: scalar; w_rows: (B, L); v_rows: (B, L, K); vals: (B, L).
    """
    vals_c = vals.astype(compute_dtype)
    vx = v_rows.astype(compute_dtype) * vals_c[..., None]
    out = interaction_from_rows(vx)
    if use_linear:
        out = out + jnp.sum(w_rows.astype(compute_dtype) * vals_c, axis=-1)
    if use_bias:
        out = out + w0.astype(compute_dtype)
    return out.astype(jnp.float32)


def ffm_interaction_from_rows(vr, vals_c, field_ids, num_fields: int):
    """FFM pairwise interaction, field-aggregated.

    Each feature j carries ``num_fields`` latent vectors; the pair (a, b)
    with fields (f_a, f_b) contributes <v_a[f_b], v_b[f_a]> * x_a * x_b.

    Instead of materializing per-pair tensors (the old path built a
    (B, L, L, K) "factor toward the other slot's field" tensor — hundreds
    of MB at Avazu shapes, VERDICT r1 item 7), aggregate by SOURCE field:

        S[b, u, t, :] = sum_{a: field(a)=u} x_a * v_a[t, :]     (B, F, F, K)

    Then the ordered-pair total telescope-sums over field pairs:

        T = sum_{t,u} <S[u, t], S[t, u]>

    and the unordered interaction is (T - D) / 2 where D removes the a == b
    self-pairs: D = sum_a x_a^2 |v_a[f_a]|^2. Identical math to the
    pairwise form (parity-tested), O(B·F²·K) memory instead of O(B·L²·K),
    and the one-hot contraction is a batched matmul.

    Args:
      vr: (B, L, F, K) gathered per-slot per-target-field factors
          (compute dtype), or flat (B, L, F*K) — the STORAGE layout is
          flat (models/fm.py::FMParams).
      vals_c: (B, L) values (padding exactly 0).
      field_ids: (B, L) int32 field of each slot.
    """
    if vr.ndim == 3:
        vr = vr.reshape(vr.shape[0], vr.shape[1], num_fields, -1)
    f_oh = jax.nn.one_hot(field_ids, num_fields, dtype=vr.dtype)  # (B,L,F)
    xv = vr * vals_c[..., None, None]                       # (B, L, F, K)
    # S[b,u,t,k] = sum_a f_oh[b,a,u] * xv[b,a,t,k]
    s = jnp.einsum("bau,batk->butk", f_oh, xv)              # (B, F, F, K)
    total = jnp.einsum("butk,btuk->b", s, s)
    # self-pairs: v_a at its own field
    vaa = jnp.einsum("batk,bat->bak", xv, f_oh)             # (B, L, K)
    diag = jnp.sum(jnp.square(vaa), axis=(1, 2))
    return 0.5 * (total - diag)


def ffm_interaction_slot_major(vr, vals_c):
    """FFM interaction when slot a IS field a (the fixed-column CTR
    layout: L == num_fields and every example's slot l holds its field-l
    feature — Avazu/Criteo hashed datasets are exactly this shape).

    With field(a) == a, the field aggregation S[b,u,t,:] =
    sum_{a: field(a)=u} x_a v_a[t,:] collapses to the identity:
    S == xv. The one-hot einsums of :func:`ffm_interaction_from_rows`
    (B batched (L,F)@(L,F*K) matmuls with 22-sized operands) disappear
    entirely; the ordered-pair total is an elementwise transpose
    multiply:

        T = sum_{t,u} <xv[u,t], xv[t,u]>,   diag_a = |xv[a,a]|^2

    Parity vs the aggregated and pairwise forms is pinned in
    tests/test_fm_math.py.

    Args:
      vr: (B, L, F, K) gathered factors with L == F.
      vals_c: (B, L) values (padding exactly 0).
    """
    B, L, Fq, K = vr.shape
    if L != Fq:
        raise ValueError(
            f"slot-major FFM requires one slot per field (L == num_fields),"
            f" got L={L}, num_fields={Fq}")
    xv = vr * vals_c[..., None, None]                       # (B, L, F, K)
    xvt = jnp.swapaxes(xv, 1, 2)
    total = jnp.sum(xv * xvt, axis=(1, 2, 3))
    ar = jnp.arange(L)
    diag = jnp.sum(jnp.square(xv[:, ar, ar, :]), axis=(1, 2))
    return 0.5 * (total - diag)


def ffm_scores_from_gathered(w0, w_rows, v_rows, vals, field_ids,
                             num_fields: int,
                             use_bias: bool = True, use_linear: bool = True,
                             compute_dtype=jnp.float32,
                             slot_major: bool = False) -> jnp.ndarray:
    """Field-aware FM (FFM) scores from gathered per-field factor rows.

    Uses the field-aggregated O(B·F²·K) interaction
    (:func:`ffm_interaction_from_rows`); the O(B·L²·K) pairwise form is
    kept as :func:`ffm_scores_pairwise` for parity tests. With
    ``slot_major`` (a STATIC config bit: FMConfig.slot_major_fields),
    field_ids are ignored (may be None) and the cheaper transpose-form
    interaction runs instead (:func:`ffm_interaction_slot_major`).

    Args:
      v_rows: (B, L, num_fields, K) — or flat (B, L, num_fields*K), the
          storage layout — per-slot, per-target-field factors.
      field_ids: (B, L) int32 field of each active feature.
    """
    vals_c = vals.astype(compute_dtype)
    vr = v_rows.astype(compute_dtype)
    if vr.ndim == 3:
        vr = vr.reshape(vr.shape[0], vr.shape[1], num_fields, -1)
    if slot_major:
        out = ffm_interaction_slot_major(vr, vals_c)
    else:
        out = ffm_interaction_from_rows(vr, vals_c, field_ids, num_fields)
    if use_linear:
        out = out + jnp.sum(w_rows.astype(compute_dtype) * vals_c, axis=-1)
    if use_bias:
        out = out + w0.astype(compute_dtype)
    return out.astype(jnp.float32)


def ffm_scores_pairwise(w0, w_rows, v_rows, vals, field_ids,
                        num_fields: int,
                        use_bias: bool = True, use_linear: bool = True,
                        compute_dtype=jnp.float32) -> jnp.ndarray:
    """The direct per-pair FFM form (O(B·L²·K) memory): for each ordered
    slot pair (a, b), contrib = <v_a[field(b)], v_b[field(a)]> x_a x_b over
    the strict upper triangle. Semantics oracle for the aggregated path."""
    B, L = vals.shape
    vals_c = vals.astype(compute_dtype)
    vr = v_rows.astype(compute_dtype)
    if vr.ndim == 3:
        vr = vr.reshape(B, L, num_fields, -1)
    f_oh = jax.nn.one_hot(field_ids, num_fields, dtype=compute_dtype)
    # v_toward[b, a, c, :] = vr[b, a, field(c)]
    v_toward = jnp.einsum("batk,bct->back", vr, f_oh)        # (B, L, L, K)
    pair_dot = jnp.einsum("back,bcak->bac", v_toward, v_toward)
    xx = vals_c[:, :, None] * vals_c[:, None, :]             # (B, L, L)
    iu = jnp.triu(jnp.ones((L, L), dtype=bool), k=1)
    out = jnp.sum(jnp.where(iu[None], pair_dot * xx, 0.0), axis=(1, 2))
    if use_linear:
        out = out + jnp.sum(w_rows.astype(compute_dtype) * vals_c, axis=-1)
    if use_bias:
        out = out + w0.astype(compute_dtype)
    return out.astype(jnp.float32)
