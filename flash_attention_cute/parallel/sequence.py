"""Sequence/context parallelism: attention over a sequence-sharded mesh.

The reference handles long sequences only via its in-kernel KV-block loop
(reference: csrc/flash_attention_template.cuh:342-343); anything beyond one
device's HBM is out of scope there. Here (SURVEY.md §5 long-context):

  * `allgather_attention` — KV all-gathered over the `sp` axis, each shard
    runs the dense attention route on its local queries with
    `q_offset = shard_index * S_local` (global causality falls out of the
    per-row offset support). One collective; KV memory O(S_global) per
    card — the right choice while the gathered KV fits (e.g. 32k tokens of
    Llama-3-8B KV/layer = 16 MB).
  * `ring_attention` — K/V chunks rotate around the ring via `ppermute`
    while each shard folds one chunk per step into a running online
    softmax (the cross-card version of the kernel's m/l/acc recurrence,
    csrc/flash_attention_template.cuh:445-487). KV memory O(S_local);
    compute of step t overlaps the transfer of step t+1 as XLA schedules
    the collective-permute asynchronously. Causal chunks strictly above
    the diagonal contribute nothing and are masked with `where`.

Both are exact (parity-tested against the dense single-device reference on
a virtual 8-device mesh).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from flash_attention_cute.api import flash_attention_forward


def allgather_attention(
    q: jax.Array,  # [B, H, S, D] — S sharded over `axis`
    k: jax.Array,
    v: jax.Array,
    mesh: Mesh,
    axis: str = "sp",
    causal: bool = True,
    sm_scale: float | None = None,
    window: int | None = None,
    interpret: bool | None = None,
) -> jax.Array:
    """Sequence-parallel attention via a KV all-gather."""

    def inner(q, k, v):
        n = jax.lax.axis_size(axis)
        idx = jax.lax.axis_index(axis)
        b, h, s_local, d = q.shape
        kg = jax.lax.all_gather(k, axis, axis=2, tiled=True)
        vg = jax.lax.all_gather(v, axis, axis=2, tiled=True)
        q_off = jnp.full((b,), idx * s_local, jnp.int32)
        kv_len = jnp.full((b,), n * s_local, jnp.int32)
        return flash_attention_forward(
            q, kg, vg, softmax_scale=sm_scale, causal=causal,
            kv_length=kv_len, q_offset=q_off, window=window,
            interpret=interpret,
        )

    spec = P(None, None, axis, None)
    return jax.shard_map(
        inner, mesh=mesh, in_specs=(spec, spec, spec), out_specs=spec,
        check_vma=False,
    )(q, k, v)


def ring_attention(
    q: jax.Array,  # [B, H, S, D] — S sharded over `axis`
    k: jax.Array,
    v: jax.Array,
    mesh: Mesh,
    axis: str = "sp",
    causal: bool = True,
    sm_scale: float | None = None,
    interpret: bool | None = None,
) -> jax.Array:
    """Sequence-parallel attention with O(S_local) KV memory per chip.

    Per ring step, each shard holds one rotating KV chunk and folds it
    into running (m, l, acc) online-softmax state; `ppermute` moves chunks
    to the next neighbor. The per-chunk partial is plain XLA in fp32.
    """
    del interpret
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5

    def inner(q, k, v):
        n = jax.lax.axis_size(axis)
        idx = jax.lax.axis_index(axis)
        b, hq, s_local, d = q.shape
        hkv = k.shape[1]
        if hkv != hq:
            rep = hq // hkv
            k_ = jnp.repeat(k, rep, axis=1)
            v_ = jnp.repeat(v, rep, axis=1)
        else:
            k_, v_ = k, v

        qf = q.astype(jnp.float32) * sm_scale
        rows = jnp.arange(s_local)

        perm = [(i, (i + 1) % n) for i in range(n)]

        def step(carry, t):
            k_t, v_t, m, l, acc = carry
            src = (idx - t) % n  # global chunk id currently held

            s = jnp.einsum(
                "bhqd,bhkd->bhqk", qf, k_t.astype(jnp.float32),
                precision=jax.lax.Precision.HIGHEST,
            )
            if causal:
                # Global causality at chunk granularity + in-chunk diagonal.
                cols = jnp.arange(s_local)
                in_chunk = cols[None, :] <= rows[:, None]
                allowed = jnp.where(
                    src == idx,
                    in_chunk,
                    jnp.broadcast_to((src < idx), (s_local, s_local)),
                )
                s = jnp.where(allowed[None, None], s, -jnp.inf)

            m_curr = jnp.max(s, axis=-1)  # [B,H,Sq]
            m_next = jnp.maximum(m, m_curr)
            # Guard -inf - -inf (fully masked chunk rows).
            safe_m = jnp.where(jnp.isneginf(m_next), 0.0, m_next)
            alpha = jnp.where(
                jnp.isneginf(m), 0.0, jnp.exp(m - safe_m)
            )
            p = jnp.exp(s - safe_m[..., None])
            p = jnp.where(jnp.isneginf(s), 0.0, p)
            l_next = alpha * l + jnp.sum(p, axis=-1)
            acc_next = alpha[..., None] * acc + jnp.einsum(
                "bhqk,bhkd->bhqd", p, v_t.astype(jnp.float32),
                precision=jax.lax.Precision.HIGHEST,
            )

            k_n = jax.lax.ppermute(k_t, axis, perm)
            v_n = jax.lax.ppermute(v_t, axis, perm)
            return (k_n, v_n, m_next, l_next, acc_next), None

        m0 = jnp.full((b, hq, s_local), -jnp.inf, jnp.float32)
        l0 = jnp.zeros((b, hq, s_local), jnp.float32)
        acc0 = jnp.zeros((b, hq, s_local, d), jnp.float32)
        (k_f, v_f, m, l, acc), _ = jax.lax.scan(
            step, (k_, v_, m0, l0, acc0), jnp.arange(n)
        )
        l_inv = jnp.where(l == 0.0, 1.0, 1.0 / l)
        return (acc * l_inv[..., None]).astype(q.dtype)

    spec = P(None, None, axis, None)
    return jax.shard_map(
        inner, mesh=mesh, in_specs=(spec, spec, spec), out_specs=spec,
        check_vma=False,
    )(q, k, v)
