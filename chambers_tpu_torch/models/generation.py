"""Autoregressive decoding for encoder-decoder models (port of
``chambers_tpu/models/generation.py``).

``greedy_decode``, ``sample_decode`` and ``beam_search_decode`` take a
``Seq2SeqTransformer``-shaped module (``model([tokens, targets])`` ->
``[b, t, vocab]`` logits, causal target self-attention, token ``pad_id``
as padding) and the source tokens, with the JAX functions' keyword
arguments; the module holds its own weights, so there is no ``variables``
argument. Each is a plain Python loop over the ``max_len`` steps that runs
without gradients and reads nothing back to the host inside the loop.

The encoder runs once per call. With ``use_cache`` (the default where the
module supports it) each step feeds one token through the incremental
decode cache (``Seq2SeqTransformer.init_cache`` / ``decode_step``): a
step's self-attention attends over a ``[b, n, max_len, h]`` buffer, its
cross attention over the memory's keys and values projected once. On
``attention_impl="flash"`` those are K3a launches at one query row, where
the JAX package runs dense attention for a cached step. ``use_cache=False``
re-runs the decoder over the whole target buffer each step; padding and the
causal mask keep position ``i``'s logits independent of the later ones, so
both emit the same tokens (exactly in float32; in bf16 near-tied logits
can round apart).

Sampling: ``jax.random`` cannot be replayed, so ``sample_decode`` draws
its Gumbel noise from a ``torch.Generator``, or takes it from the caller
as ``gumbel_noise`` (one ``[b, vocab]`` array per step): a draw is
``argmax(logits + noise)``, what ``jax.random.categorical`` computes.

On a mesh (``chambers_tpu_torch.parallel``) the source tokens may come as
a ``DTensor`` sharded by rows (``shard_batch``): each rank decodes its rows
and the result is sharded the same way; a module placed with tensor
parallel rules decodes on its heads' shards (its caches hold this rank's
heads).

Beam search keeps ``lax.top_k``'s order: among equal scores the lower
index comes first (a stable descending sort). Between steps the beams'
self-attention caches are reordered to their parents; the cross-attention
entries are left as they are, since every beam of a source row holds the
same memory.
"""

import functools
import sys
import warnings

import torch


class QuantizedDecodeWarning(UserWarning):
    """Decode called on an int8-quantized model — usually slower, not
    faster."""


def _warn_if_quantized(model):
    """Warn when decode receives an int8-quantized model (int8 kernels or
    ``*_scale`` buffers set by ``quantization.quantize_model``): the
    per-step ``[b, 1, d]`` products are too small to gain from int8, and
    the per-token activation quantize sits on every step's critical path.
    Decoding still works and matches the quantized full-recompute path."""
    quantized = (any(p.dtype == torch.int8 for p in model.parameters())
                 or any(name.endswith("_scale")
                        for name, _ in model.named_buffers()))
    if quantized:
        warnings.warn(
            "decoding with int8-quantized variables: per-step decode "
            "products are too small to benefit from int8 and run slower "
            "than float. Keep a float copy of the model for generation.",
            QuantizedDecodeWarning, stacklevel=3)


def _cache_supported(model) -> bool:
    """True when the module has the incremental-decode surface and a dense
    decoder (mixture-of-experts routing couples the positions)."""
    return (hasattr(model, "encode") and hasattr(model, "decode_step")
            and getattr(model, "moe_every_n", 0) == 0)


def _resolve_use_cache(model, use_cache) -> bool:
    if use_cache is None:
        return _cache_supported(model)
    if use_cache and not _cache_supported(model):
        raise NotImplementedError(
            "use_cache=True needs the module to expose encode/decode_step "
            "and a dense (non-MoE) decoder; got "
            f"{type(model).__name__} with moe_every_n="
            f"{getattr(model, 'moe_every_n', 0)}. Pass use_cache=False.")
    return bool(use_cache)


def _encode(model, tokens, repeat):
    """The memory and its mask, each source row repeated ``repeat``
    times."""
    x_enc, input_mask = model.encode(tokens, deterministic=True)
    if repeat > 1:
        x_enc = x_enc.repeat_interleave(repeat, dim=0)
        input_mask = input_mask.repeat_interleave(repeat, dim=0)
    return x_enc, input_mask


def _prime_cache(model, tokens, max_len, repeat=1):
    """Run the encoder once and prime the cache for ``max_len`` positions;
    returns ``(step, cache)`` with ``step(token, i, cache) -> (logits
    [b·repeat, 1, vocab], cache)``."""
    x_enc, input_mask = _encode(model, tokens, repeat)
    cache = model.init_cache(x_enc, max_len)

    def step(token, i, cache):
        return model.decode_step(token, i, x_enc, input_mask, max_len, cache)

    return step, cache


def _make_stepper(model, tokens, repeat=1):
    """``step(tgt) -> [b·repeat, t, vocab]`` logits over a whole target
    buffer. With ``encode``/``decode`` the encoder runs once, over the
    unrepeated sources; otherwise every step runs the full forward."""
    if hasattr(model, "encode") and hasattr(model, "decode"):
        x_enc, input_mask = _encode(model, tokens, repeat)

        def step(tgt):
            return model.decode(tgt, x_enc, input_mask, deterministic=True)

        return step
    src = tokens.repeat_interleave(repeat, dim=0) if repeat > 1 else tokens
    return lambda tgt: model([src, tgt], deterministic=True)


def _decode_loop(step_logits, select, b, max_len, bos_id, eos_id, pad_id,
                 device):
    """Greedy/sampling loop over a whole target buffer: ``select(i,
    float32 logits)`` picks each step's tokens; a finished row emits
    ``pad_id``."""
    tgt = torch.full((b, max_len), pad_id, dtype=torch.long, device=device)
    tgt[:, 0] = bos_id
    out = torch.full((b, max_len), pad_id, dtype=torch.long, device=device)
    finished = torch.zeros((b,), dtype=torch.bool, device=device)
    for i in range(max_len):
        logits = step_logits(tgt)
        nxt = select(i, logits[:, i].float())
        nxt = torch.where(finished, pad_id, nxt)
        out[:, i] = nxt
        if eos_id is not None:
            finished = finished | (nxt == eos_id)
        if i + 1 < max_len:
            tgt[:, i + 1] = nxt
    return out


def _cached_decode_loop(model, tokens, select, max_len, bos_id, eos_id,
                        pad_id):
    """Greedy/sampling loop over the decode cache: one token a step."""
    step, cache = _prime_cache(model, tokens, max_len)
    b, device = tokens.shape[0], tokens.device
    token = torch.full((b, 1), bos_id, dtype=torch.long, device=device)
    out = torch.full((b, max_len), pad_id, dtype=torch.long, device=device)
    finished = torch.zeros((b,), dtype=torch.bool, device=device)
    for i in range(max_len):
        logits, cache = step(token, i, cache)
        nxt = select(i, logits[:, 0].float())
        nxt = torch.where(finished, pad_id, nxt)
        out[:, i] = nxt
        if eos_id is not None:
            finished = finished | (nxt == eos_id)
        token = nxt[:, None]
    return out


def _run(model, tokens, select, max_len, bos_id, eos_id, pad_id, use_cache):
    if _resolve_use_cache(model, use_cache):
        return _cached_decode_loop(model, tokens, select, max_len, bos_id,
                                   eos_id, pad_id)
    return _decode_loop(_make_stepper(model, tokens), select,
                        tokens.shape[0], max_len, bos_id, eos_id, pad_id,
                        tokens.device)


def _sharded_rows(decode):
    """Let ``decode`` take the source tokens as a ``DTensor`` sharded by
    rows (``parallel.shard_batch``): it decodes this rank's rows, inside
    ``parallel.distributed.data_parallel`` over that axis, and returns its
    results sharded the same way."""

    @functools.wraps(decode)
    def wrapper(model, tokens, *args, **kwargs):
        # no DTensor exists before its module is loaded: the common path
        # imports nothing
        dtensor = sys.modules.get("torch.distributed.tensor")
        if dtensor is None or not isinstance(tokens, dtensor.DTensor):
            return decode(model, tokens, *args, **kwargs)
        from chambers_tpu_torch.parallel.distributed import data_parallel

        mesh, placements = tokens.device_mesh, tokens.placements
        axis = next(name for name, p in zip(mesh.mesh_dim_names, placements)
                    if isinstance(p, dtensor.Shard) and p.dim == 0)
        with data_parallel(model, mesh, axis):
            out = decode(model, tokens.to_local(), *args, **kwargs)

        def wrap(t):
            return dtensor.DTensor.from_local(t, mesh, placements)

        return tuple(map(wrap, out)) if isinstance(out, tuple) else wrap(out)

    return wrapper


@torch.no_grad()
@_sharded_rows
def greedy_decode(model, tokens, *, max_len, bos_id, eos_id=None, pad_id=0,
                  use_cache=None):
    """Greedy-decode ``max_len`` tokens for every source row.

    :param model: a ``Seq2SeqTransformer``-shaped module.
    :param tokens: ``[b, t_src]`` integer source tokens on the model's
        device.
    :param max_len: number of steps.
    :param bos_id: begin-of-sequence token fed at target position 0.
    :param eos_id: optional end token; once a row emits it, its later
        positions emit ``pad_id`` (the ``eos_id`` itself is kept).
    :param pad_id: the padding id (0, the reference's ``mask_zero``).
    :param use_cache: decode through the incremental cache; ``None`` means
        cached where the module supports it.
    :returns: ``[b, max_len]`` int64, the token predicted at each target
        position (BOS not included).
    """
    _warn_if_quantized(model)
    return _run(model, tokens, lambda i, logits: logits.argmax(dim=-1),
                max_len, bos_id, eos_id, pad_id, use_cache)


def _gumbel(shape, generator, device):
    """Standard Gumbel noise ``-log(-log(u))``, ``u`` uniform in ``[tiny,
    1)``, float32 — the form of ``jax.random.gumbel``."""
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(u.clamp_(min=torch.finfo(u.dtype).tiny)))


@torch.no_grad()
@_sharded_rows
def sample_decode(model, tokens, generator=None, *, max_len, bos_id,
                  temperature=1.0, top_k=None, top_p=None, eos_id=None,
                  pad_id=0, use_cache=None, gumbel_noise=None):
    """Temperature sampling over the same loop as :func:`greedy_decode`.

    Each step draws from ``softmax(logits / temperature)`` restricted by
    :func:`apply_top_k_top_p` (temperature, then top-k, then top-p), as
    ``argmax(scaled logits + Gumbel noise)``. The noise of step ``i`` is
    ``gumbel_noise[i]`` (``[b, vocab]``) when given, else drawn from
    ``generator`` on the tokens' device.
    """
    if temperature <= 0:
        raise ValueError(f"temperature={temperature} must be > 0 "
                         "(use greedy_decode for argmax decoding)")
    _warn_if_quantized(model)
    # 1 / temperature rounded to float32, as the JAX function holds it
    inv_t = float(torch.tensor(1.0 / temperature, dtype=torch.float32))

    def select(i, logits):
        scaled = apply_top_k_top_p(logits * inv_t, top_k, top_p)
        if gumbel_noise is not None:
            noise = torch.as_tensor(gumbel_noise[i], dtype=torch.float32,
                                    device=logits.device)
        else:
            noise = _gumbel(scaled.shape, generator, logits.device)
        return (scaled + noise).argmax(dim=-1)

    return _run(model, tokens, select, max_len, bos_id, eos_id, pad_id,
                use_cache)


def apply_top_k_top_p(logits, top_k=None, top_p=None):
    """Restrict ``[..., vocab]`` float32 logits to the top-k and/or nucleus
    (top-p) candidates by setting everything else to ``-inf``.

    Top-k keeps every logit ``>=`` the k-th largest (ties at the threshold
    all survive; ``top_k`` above the vocabulary keeps all). Top-p keeps the
    smallest prefix of the descending-sorted distribution whose cumulative
    probability reaches ``top_p``; the first token always survives.
    """
    if top_k is not None:
        if top_k < 1:
            raise ValueError(f"top_k={top_k} must be >= 1")
        k = min(int(top_k), logits.shape[-1])
        kth = torch.topk(logits, k, dim=-1).values[..., -1:]
        logits = torch.where(logits >= kth, logits, -torch.inf)
    if top_p is not None:
        if not 0.0 < top_p <= 1.0:
            raise ValueError(f"top_p={top_p} must be in (0, 1]")
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        # probability of the strictly higher-ranked tokens: a token is kept
        # while that is below top_p, so the first always is
        cum = torch.cumsum(probs, dim=-1) - probs
        threshold = torch.where(cum < top_p, sorted_logits, torch.inf).amin(
            dim=-1, keepdim=True)
        logits = torch.where(logits >= threshold, logits, -torch.inf)
    return logits


def _finalize_beams(out, scores, pad_id, length_penalty):
    """The best of ``k`` hypotheses per row, ``(best [b, max_len], score
    [b])``. ``length_penalty=0`` keeps the raw ranking (beam 0); otherwise
    the final hypotheses are re-ranked by the GNMT penalty ``score / ((5 +
    L) / 6) ** alpha``, ``L`` the non-pad tokens, and the score returned is
    the normalized one."""
    if not length_penalty:
        return out[:, 0], scores[:, 0]
    lengths = (out != pad_id).sum(dim=-1).float()                  # [b, k]
    penalty = ((5.0 + lengths) / 6.0) ** length_penalty
    normalized = scores / penalty.clamp(min=1e-9)
    best_idx = normalized.argmax(dim=-1)                            # [b]
    rows = torch.arange(out.shape[0], device=out.device)
    return out[rows, best_idx], normalized[rows, best_idx]


def _gather_beam_cache(cache, parent, b, k):
    """Reorder every layer's self-attention cache (leading dimension
    ``b·k``) to the winning parent beams; ``cache_index`` passes through.
    The cross-attention entries are the same for every beam of a row and
    are not moved."""
    flat = (torch.arange(b, device=parent.device)[:, None] * k
            + parent).flatten()
    out = []
    for layer in cache:
        self_cache = dict(layer["multi_head_attention1"])
        for name in ("cached_key", "cached_value", "valid_mask"):
            self_cache[name] = self_cache[name].index_select(0, flat)
        out.append(dict(layer, multi_head_attention1=self_cache))
    return out


def _top_k_stable(x, k):
    """``lax.top_k`` over the last axis: the ``k`` largest, descending,
    the lower index first among equal values."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


@torch.no_grad()
@_sharded_rows
def beam_search_decode(model, tokens, *, max_len, bos_id, beam_size,
                       eos_id=None, pad_id=0, length_penalty=0.0,
                       return_scores=False, use_cache=None):
    """Beam search over a ``[b·beam]`` decode batch (the encoder still runs
    once over the ``[b]`` sources), one joint top-k over the (beam ×
    vocab) candidates a step.

    Scores are sums of ``log_softmax`` token log-probabilities. With
    ``eos_id`` set, a finished hypothesis emits ``pad_id`` at no cost from
    then on and keeps competing for a slot. ``beam_size=1`` is
    :func:`greedy_decode`. ``length_penalty`` (alpha > 0) re-ranks the
    final hypotheses (:func:`_finalize_beams`).

    :returns: ``[b, max_len]`` int64 best sequences, or ``(sequences,
        scores)`` with ``[b]`` float32 scores when ``return_scores``.
    """
    if beam_size < 1:
        raise ValueError(f"beam_size={beam_size} must be >= 1")
    _warn_if_quantized(model)
    b, k, device = tokens.shape[0], beam_size, tokens.device
    out = torch.full((b, k, max_len), pad_id, dtype=torch.long,
                     device=device)
    # all k hypotheses start identical: only beam 0 has a live score, so
    # step 0's joint top-k picks k distinct first tokens
    scores = torch.full((b, k), -torch.inf, device=device)
    scores[:, 0] = 0.0
    finished = torch.zeros((b, k), dtype=torch.bool, device=device)
    pad_only = None

    def advance(logp_flat, i, out, scores, finished):
        nonlocal pad_only
        logp = logp_flat.view(b, k, -1)
        vocab = logp.shape[-1]
        if eos_id is not None:
            # finished hypotheses: pad at no cost, everything else -inf
            if pad_only is None:
                pad_only = torch.full((vocab,), -torch.inf, device=device)
                pad_only[pad_id] = 0.0
            logp = torch.where(finished[:, :, None], pad_only, logp)
        total = (scores[:, :, None] + logp).view(b, k * vocab)
        scores, flat_idx = _top_k_stable(total, k)
        parent = flat_idx // vocab
        token = flat_idx % vocab
        out = out.gather(1, parent[:, :, None].expand(-1, -1, max_len))
        out[:, :, i] = token
        if eos_id is not None:
            finished = finished.gather(1, parent) | (token == eos_id)
        return parent, token, out, scores, finished

    if _resolve_use_cache(model, use_cache):
        step, cache = _prime_cache(model, tokens, max_len, repeat=k)
        token_in = torch.full((b * k, 1), bos_id, dtype=torch.long,
                              device=device)
        for i in range(max_len):
            logits, cache = step(token_in, i, cache)
            logp_flat = torch.log_softmax(logits[:, 0].float(), dim=-1)
            parent, token, out, scores, finished = advance(
                logp_flat, i, out, scores, finished)
            # each surviving hypothesis continues from its parent's state
            cache = _gather_beam_cache(cache, parent, b, k)
            token_in = token.reshape(b * k, 1)
    else:
        step_logits = _make_stepper(model, tokens, repeat=k)
        tgt = torch.full((b * k, max_len), pad_id, dtype=torch.long,
                         device=device)
        tgt[:, 0] = bos_id
        for i in range(max_len):
            logits = step_logits(tgt)
            logp_flat = torch.log_softmax(logits[:, i].float(), dim=-1)
            parent, token, out, scores, finished = advance(
                logp_flat, i, out, scores, finished)
            # reorder the target buffer to the winning parents
            tgt = tgt.view(b, k, max_len).gather(
                1, parent[:, :, None].expand(-1, -1, max_len))
            if i + 1 < max_len:
                tgt[:, :, i + 1] = token
            tgt = tgt.reshape(b * k, max_len)
    best, best_scores = _finalize_beams(out, scores, pad_id, length_penalty)
    return (best, best_scores) if return_scores else best
