"""Decoder-only LM stack (counterpart of ``repro.models.transformer``).

Covers the dense transformers (tinyllama, qwen3-0.6b, llama3.2-3b,
granite-20b), the MoE ones (qwen3-moe-235b-a22b, arctic-480b), jamba
(mamba and attention interleaved, MoE every other layer) and qwen2-vl
(M-RoPE, and stub vision embeds that replace the first token slots). A block is a
sequence mixer (attention or mamba) and then an FFN (dense or MoE). Params
keep the reference's tree, so a JAX param tree crosses over through
``interop`` unchanged:
- ``"blocks"``: a homogeneous stack, each leaf stacked along a leading
  layer axis (the reference stacks them for ``lax.scan``);
- ``"groups"``: jamba when the period divides the depth, a list of one
  period's blocks, each leaf stacked over the groups;
- ``"layers"``: otherwise (jamba at a depth its period does not divide),
  a list of per-layer blocks.
Here a Python loop walks the layers. ``init_lm`` allocates each stacked
leaf once and draws every layer into its slice, so the stack is never held
twice.

qwen2-vl's batches carry ``vision_embeds`` (B, Sv, d), which take the
place of the first Sv token rows (the reference's stub modality merge),
and ``positions3`` (3, B, S), the (temporal, height, width) positions its
attention turns q and k by (M-RoPE). Without ``positions3`` attention uses
plain rope at the token positions, as the reference's decode step does.

Caches keep the reference's trees too: ``{"k", "v"}`` of (L, B, Smax,
Hkv, D) for a homogeneous stack; for jamba a list over the period of
``{"k", "v"}`` or mamba ``{"h", "conv"}`` states, stacked over the groups.
They are written in place: ``prefill`` and ``decode_step`` return the
caches they were given.

``forward_hidden`` sums the MoE blocks' load-balancing terms, and
``lm_loss`` adds 0.01 of that sum to the mean cross-entropy, as the
reference does (``src/repro/models/transformer.py:205``); a stack with no
MoE block adds nothing.

Under a sharding context whose rules name ``heads`` the decoders run
with dense tensor parallelism (``distributed.tensor_parallel``): each
rank holds its column, row and vocab blocks of the projections and the
head, and its kv heads in the caches (the reference's ``cache_seq`` rule
for decode is not applied then: a cache holds the rank's heads over every
position); the MoE blocks run expert-parallel over the same axis
(``models.moe``) and arctic's dense residual as a tensor-parallel MLP;
jamba's mamba mixers run the rank's SSD heads, their states holding those
heads and channels (``models.mamba``). Under a ``seq`` rule over the same axis (Megatron-SP) the
residual stream between blocks is each rank's S/tp rows; the final hidden
states are gathered whole along the sequence before the head, which is
vocab-parallel. Under a ``w_embed`` rule (FSDP) a rank holds a block of
each projection and of the head over ``data`` as well, gathered at its use
(``distributed.fsdp``); where ``model`` does not divide the kv heads each
rank reads them whole, and its caches hold the ones its query heads read.

Training differentiates ``lm_loss`` with torch autograd. With ``cfg.remat``
each block runs under ``torch.utils.checkpoint``, as the reference wraps
its block in ``jax.checkpoint`` (``src/repro/models/transformer.py:139``):
only the block's input is kept, and the block (its flash-attention forward
and its routing included) runs again in the backward.
"""
from __future__ import annotations

import torch
import torch.utils.checkpoint

from repro_torch.core import embedding_ops
from repro_torch.distributed import context_parallel, fsdp, sharding
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.models import layers, mamba, moe
from repro_torch.tree import tree_map


def _check_supported(cfg) -> None:
    if cfg.arch_type not in ("transformer", "jamba", "qwen2vl"):
        raise NotImplementedError(
            f"{cfg.name}: this module runs the transformer, jamba and qwen2vl "
            f"stacks, not {cfg.arch_type!r}")


def _is_homogeneous(cfg) -> bool:
    return (len(set(cfg.layer_types)) == 1 and len(set(cfg.ffn_types)) == 1
            and cfg.arch_type in ("transformer", "qwen2vl"))


def _init_block(gen: torch.Generator, cfg, layer_type: str, ffn_type: str,
                new=None, keep=None):
    dt = cfg.activation_dtype
    p = {"norm1": layers.ones(gen, (cfg.d_model,), dt, new),
         "norm2": layers.ones(gen, (cfg.d_model,), dt, new)}
    if layer_type == "attn":
        p["attn"] = layers.init_attention(gen, cfg, new, keep)
    else:
        p["mamba"] = mamba.init_mamba(gen, cfg, new, keep)
    if ffn_type == "moe":
        p["moe"] = moe.init_moe(gen, cfg, new, keep)
    else:
        p["mlp"] = layers.init_mlp(gen, cfg, new=new, keep=keep)
    return p


def init_lm(gen: torch.Generator, cfg, keep=None):
    """Random params on ``gen``'s device in the reference's tree layout.
    ``keep(path, leaf)``, if given, cuts the token table, the experts and
    (under dense tensor parallelism) each layer's projections and the head
    as soon as it is drawn (``distributed.sharding.keep_shard``: a rank's
    part); the draws are those of the whole model."""
    _check_supported(cfg)
    dt = cfg.activation_dtype
    table = (torch.randn((cfg.vocab_size, cfg.d_model), generator=gen,
                         device=gen.device) * 0.02).to(dt)
    if keep is not None:
        table = keep("embed/table", table)
    params = {"embed": {"table": table},
              "final_norm": layers.ones(gen, (cfg.d_model,), dt)}
    if not cfg.tie_embeddings:
        params["lm_head"] = layers.dense_init(gen, cfg.d_model, cfg.vocab_size, dt,
                                              keep=keep, path="lm_head")
    lt, ft, L = cfg.layer_types, cfg.ffn_types, cfg.num_layers
    if _is_homogeneous(cfg):
        stack = layers.Stack(L, gen.device)
        trees = [_init_block(gen, cfg, lt[0], ft[0], stack.layer(i), keep)
                 for i in range(L)]
        params["blocks"] = stack.tree(trees[0])
    elif cfg.arch_type == "jamba" and L % cfg.attn_layer_period == 0:
        period = cfg.attn_layer_period
        stacks = [layers.Stack(L // period, gen.device) for _ in range(period)]
        groups = [[_init_block(gen, cfg, lt[i], ft[i], stacks[i].layer(g), keep)
                   for i in range(period)] for g in range(L // period)]
        params["groups"] = [s.tree(t) for s, t in zip(stacks, groups[0], strict=True)]
    else:
        params["layers"] = [_init_block(gen, cfg, lt[i], ft[i], keep=keep)
                            for i in range(L)]
    return params


def _block_fwd(p, cfg, layer_type, ffn_type, x, positions, positions3=None,
               cache=None, cache_index=None, local_batch=False):
    """One block. Returns (x, aux): aux is the MoE's load-balancing term, or
    None after a dense FFN. ``local_batch``: as ``forward_hidden``'s."""
    h = layers.rms_norm(x, p["norm1"], cfg.norm_eps)
    if layer_type == "attn":
        o, _ = layers.attention_fwd(p["attn"], cfg, h, positions, causal=True,
                                    cache=cache, cache_index=cache_index,
                                    positions3=positions3)
    else:
        o, _ = mamba.mamba_fwd(p["mamba"], cfg, h, state=cache,
                               cache_index=cache_index)
    x = x + o
    h = layers.rms_norm(x, p["norm2"], cfg.norm_eps)
    if ffn_type == "moe":
        o, aux = moe.moe_fwd(p["moe"], cfg, h, local_batch)
        return x + o, aux
    return x + layers.mlp_fwd(p["mlp"], cfg, h), None


def _walk(params, cfg, caches):
    """(block params, layer type, ffn type, cache) for each layer, in order;
    the caches are views of ``caches`` (None without)."""
    lt, ft, L = cfg.layer_types, cfg.ffn_types, cfg.num_layers

    def at(tree, i):
        return None if tree is None else tree_map(lambda a: a[i], tree)
    if "blocks" in params:
        for i, bp in enumerate(layers.layer_params(params["blocks"], L)):
            yield bp, lt[0], ft[0], at(caches, i)
    elif "groups" in params:
        period = cfg.attn_layer_period
        ngroups = L // period
        per = [layers.layer_params(gp, ngroups) for gp in params["groups"]]
        for g in range(ngroups):
            for i in range(period):
                yield per[i][g], lt[i], ft[i], None if caches is None else at(caches[i], g)
    else:
        if caches is not None and len(caches) != L:
            raise ValueError(
                f"{cfg.name}: {L} layers in the per-layer layout, but the caches "
                f"hold {len(caches)} entries (init_kv_cache gives jamba the "
                "group layout, as the reference does, which this depth cannot use)")
        for i, bp in enumerate(params["layers"]):
            yield bp, lt[i], ft[i], None if caches is None else caches[i]


def forward_hidden(params, cfg, tokens, *, caches=None, cache_index=None,
                   vision_embeds=None, positions3=None, embed_rows=None,
                   local_batch=False):
    """tokens: (B, S) -> (hidden (B, S, d), caches, aux).

    The token embedding goes through the row-gather kernel, unless
    ``embed_rows`` gives the (B, S, d) rows already gathered (the relaxed
    lookup's prefetch); ``vision_embeds`` (B, Sv, d) then replace the first
    Sv rows. Tokens sit at positions cache_index .. cache_index + S - 1;
    ``positions3`` (3, B, S), if given, are the M-RoPE positions. With grad
    on and ``cfg.remat``, each block is checkpointed. aux is the summed
    load-balancing term of the MoE blocks, None without one.

    Under SP the rows are cut to the rank's S/tp after the lookup (the
    gradient of ``embed_rows`` comes back whole) and the hidden states
    returned are gathered whole again. ``local_batch``: under a sharding
    context, ``tokens`` are this rank's data group's part of the batch (the
    trainer's split), which the MoE blocks route as their group's and
    whose load-balancing term they take over the global batch; serving
    hands every rank the whole batch.
    """
    _check_supported(cfg)
    tp.check_supported(cfg)
    sp = tp.seq_parallel()
    S = tokens.shape[1]
    if embed_rows is not None:
        x = embed_rows.to(cfg.activation_dtype)
    else:
        x = embedding_ops.lookup(params["embed"]["table"], tokens, rows=cfg.vocab_size)
    if vision_embeds is not None:
        sv = vision_embeds.shape[1]
        x = torch.cat([vision_embeds.to(x.dtype), x[:, sv:]], dim=1)
    positions = (cache_index or 0) + torch.arange(S, device=tokens.device)
    if sp:
        x = tp.shard_stream(x)
    remat = cfg.remat and caches is None and torch.is_grad_enabled()
    ctx = sharding.current()    # the recompute may run on autograd's own thread

    def recomputed(bp, x, lt, ft):
        with sharding.restore(ctx):
            return _block_fwd(bp, cfg, lt, ft, x, positions, positions3,
                              local_batch=local_batch)
    total_aux = None
    for bp, lt, ft, cache in _walk(params, cfg, caches):
        if remat:
            x, aux = torch.utils.checkpoint.checkpoint(
                recomputed, bp, x, lt, ft, use_reentrant=False)
        else:
            x, aux = _block_fwd(bp, cfg, lt, ft, x, positions, positions3, cache,
                                cache_index, local_batch)
        if aux is not None:
            total_aux = aux if total_aux is None else total_aux + aux
    h = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return (tp.gather_stream(h) if sp else h), caches, total_aux


def head_matrix(params, cfg):
    """(d, V) or, where the table or ``lm_head`` is a rank's vocab block,
    (d, V/n): the vocab-parallel head (``tensor_parallel.vocab_xent``,
    ``head_logits``); under FSDP the held block of ``lm_head``, which
    ``head_mm`` gathers at its use."""
    if cfg.tie_embeddings:
        return params["embed"]["table"].T
    return params["lm_head"]


def head_mm(cfg):
    """The product with ``head_matrix``: ``fsdp.matmul`` for ``lm_head``
    (the held block gathered at its use under FSDP), the plain product for
    a head tied to the table."""
    return torch.matmul if cfg.tie_embeddings else fsdp.matmul(cfg, "lm_head")


def lm_loss(params, cfg, batch):
    """Mean token cross-entropy, plus 0.01 of the MoE blocks' summed
    load-balancing term. batch: tokens (B, S), labels (B, S) [, loss_mask,
    vision_embeds, positions3, embed_rows (the relaxed lookup's prefetched
    rows)]."""
    hidden, _, aux = forward_hidden(params, cfg, batch["tokens"],
                                    vision_embeds=batch.get("vision_embeds"),
                                    positions3=batch.get("positions3"),
                                    embed_rows=batch.get("embed_rows"),
                                    local_batch=True)
    w = head_matrix(params, cfg)
    loss, count = layers.chunked_softmax_xent(
        tp.to_head(hidden, w, cfg.vocab_size), w, batch["labels"],
        chunk=cfg.loss_chunk, mask=batch.get("loss_mask"), vocab=cfg.vocab_size,
        mm=head_mm(cfg))
    loss = loss / torch.clamp(_global_count(count), min=1.0)
    return loss if aux is None else loss + 0.01 * aux


def _global_count(count):
    """Under a sharding context, the token count over the data-parallel
    ranks divided by their number n: each rank's loss is then its sum over
    the global count times n, so that the trainer's mean of the ranks'
    gradients (``train_loop.sync_dense_``) is the global mean's, as the
    reference's step over the whole batch computes it."""
    ctx = sharding.current()
    ax = None if ctx is None else ctx.axes("batch")
    n = 1 if ax is None else ctx.mesh.axis_size(ax)
    if n == 1:
        return count
    return ctx.mesh.all_reduce(count.detach(), ax) / n


def init_kv_cache(cfg, batch: int, max_seq: int, device):
    """Zeroed caches on ``device``, in the reference's tree for ``cfg``.
    Under a ``cache_seq`` rule an attention cache holds this rank's
    ``max_seq / n`` positions (context-parallel decode); under a ``heads``
    rule the kv heads its query heads read (``tensor_parallel.local_heads``)
    over every position instead, and a mamba state its SSD heads."""
    _check_supported(cfg)
    tp.check_supported(cfg)
    L, dt = cfg.num_layers, cfg.activation_dtype
    kv = (batch, context_parallel.local_positions(max_seq), tp.local_heads(cfg)[1],
          cfg.resolved_head_dim)

    def entry(layer_type, lead=()):
        if layer_type == "attn":
            return {n: torch.zeros((*lead, *kv), dtype=dt, device=device)
                    for n in ("k", "v")}
        st = mamba.init_mamba_state(cfg, batch, device)
        return {n: torch.zeros((*lead, *a.shape), dtype=a.dtype, device=device)
                for n, a in st.items()}
    lt = cfg.layer_types
    if _is_homogeneous(cfg):
        return entry(lt[0], (L,))
    if cfg.arch_type == "jamba":
        # one period's entries, stacked over the groups (also where the
        # params take the per-layer layout, as the reference's are)
        period = cfg.attn_layer_period
        return [entry(lt[i], (L // period,)) for i in range(period)]
    return [entry(t) for t in lt]


def prefill(params, cfg, tokens, caches, *, vision_embeds=None, positions3=None):
    """Fill caches with S tokens at positions 0 .. S-1; return (last-token
    logits (B, V) f32, caches). qwen2-vl's prompt may carry vision embeds
    and M-RoPE positions."""
    hidden, caches, _ = forward_hidden(params, cfg, tokens, caches=caches,
                                       cache_index=0, vision_embeds=vision_embeds,
                                       positions3=positions3)
    return tp.head_logits(hidden[:, -1], head_matrix(params, cfg), cfg.vocab_size,
                          head_mm(cfg)), caches


def decode_step(params, cfg, tokens, pos: int, caches):
    """tokens: (B, 1) at position ``pos`` (a host int) -> (logits (B, V)
    f32, caches). qwen2-vl too turns q and k by plain rope at ``pos``, as
    the reference's serving does (it passes no M-RoPE positions here)."""
    hidden, caches, _ = forward_hidden(params, cfg, tokens, caches=caches,
                                       cache_index=pos)
    return tp.head_logits(hidden[:, -1], head_matrix(params, cfg), cfg.vocab_size,
                          head_mm(cfg)), caches
