"""HF-exact beam search and greedy decoding with scores for encoder-decoder
models (counterpart of ``beam_search``, ``expand_to_beams`` and
``greedy_decode_with_scores`` in ``mr_blip_tpu/models/generation.py``).

Semantics follow HF beam search as the JAX version does: per-step
log-softmax accumulation, EOS banned until ``min_new_tokens`` tokens
precede it, 2K candidates so finished beams can be refilled, EOS accepted
only within the top K candidates, the early-stop heuristic, and final
score ``sum_logprobs / len**length_penalty``.

The loop is eager Python over at most ``max_length`` steps, with one host
sync per step to test whether every batch row is done. The model plugs in
as a callback:
    decode_step(cache, token_ids (B*K, 1), position) -> (logits (B*K, V), cache)
"""

from __future__ import annotations

from typing import Any, Callable

import torch

NEG_INF = -1.0e7


def _top_k(x: torch.Tensor, k: int):
    """Top k along the last axis, ties to the lower index (as lax.top_k)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _gather_beams(tree: Any, beam_indices: torch.Tensor, batch_size: int,
                  num_beams: int):
    """Select beams in every tensor of a (nested list/tuple) cache whose
    leading axis is the B*K beam rows; indices (B, K)."""
    if isinstance(tree, (list, tuple)):
        return type(tree)(_gather_beams(t, beam_indices, batch_size, num_beams)
                          for t in tree)
    offsets = torch.arange(batch_size, device=beam_indices.device)[:, None] * num_beams
    return tree.index_select(0, (offsets + beam_indices).reshape(-1))


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """take_along_axis on axis 1 with idx (B, k) broadcast over the rest."""
    return torch.gather(x, 1, idx.reshape(idx.shape + (1,) * (x.ndim - 2))
                        .expand(idx.shape + x.shape[2:]))


def beam_search(decode_step: Callable, init_cache: Any, batch_size: int,
                num_beams: int = 5, max_length: int = 50,
                min_new_tokens: int = 0, eos_token_id: int = 1,
                pad_token_id: int = 0, decoder_start_token_id=0,
                length_penalty: float = 1.0, device=None):
    """Returns (sequences (B, max_length), scores (B,)) for the best beam.

    ``init_cache`` holds batch*num_beams rows. ``decoder_start_token_id``:
    one id, or a (B,) tensor of one per row (a causal LM seeds each row
    with its last prompt token)."""
    b, k = batch_size, num_beams
    alive_seqs = torch.full((b, k, max_length + 1), pad_token_id,
                            dtype=torch.long, device=device)
    alive_seqs[:, :, 0] = torch.as_tensor(
        decoder_start_token_id, dtype=torch.long, device=device).reshape(-1, 1)
    # Only beam 0 is live initially (all beams start identical).
    alive_log_probs = torch.tensor([0.0] + [NEG_INF] * (k - 1),
                                   device=device).repeat(b, 1)
    finished_seqs = torch.full_like(alive_seqs, pad_token_id)
    finished_scores = torch.full((b, k), NEG_INF, device=device)
    finished_flags = torch.zeros((b, k), dtype=torch.bool, device=device)
    done = torch.zeros((b,), dtype=torch.bool, device=device)
    first_k = torch.arange(2 * k, device=device)[None, :] < k
    cache = init_cache
    cur_len = 0
    while cur_len < max_length and not bool(done.all()):
        # 1) one decoder step for every alive beam
        tokens = alive_seqs[:, :, cur_len].reshape(b * k, 1)
        logits, cache = decode_step(cache, tokens, cur_len)
        log_probs = torch.log_softmax(logits.float(), dim=-1)
        vocab = log_probs.shape[-1]
        log_probs = log_probs.reshape(b, k, vocab)
        if cur_len < min_new_tokens:
            log_probs[:, :, eos_token_id] = NEG_INF

        cand = (alive_log_probs[:, :, None] + log_probs).reshape(b, k * vocab)
        topk_log_probs, topk_idx = _top_k(cand, 2 * k)
        topk_beam = topk_idx // vocab
        topk_token = topk_idx % vocab
        cand_seqs = _take(alive_seqs, topk_beam)
        cand_seqs[:, :, cur_len + 1] = topk_token
        is_eos = topk_token == eos_token_id
        # EOS hypotheses count only within the top K; done rows stop collecting.
        eos_counts = is_eos & first_k & ~done[:, None]

        # 2) alive set: best K non-EOS candidates
        alive_scores = torch.where(is_eos, torch.full_like(topk_log_probs, NEG_INF),
                                   topk_log_probs)
        alive_log_probs, alive_idx = _top_k(alive_scores, k)
        alive_seqs = _take(cand_seqs, alive_idx)
        cache = _gather_beams(cache, torch.gather(topk_beam, 1, alive_idx), b, k)

        # 3) finished set: accepted EOS candidates merged into the pool,
        # normalized by start + pre-EOS tokens = cur_len + 1.
        fin_cand = torch.where(
            eos_counts, topk_log_probs / ((cur_len + 1.0) ** length_penalty),
            torch.full_like(topk_log_probs, NEG_INF))
        all_seqs = torch.cat([finished_seqs, cand_seqs], dim=1)
        all_scores = torch.cat([finished_scores, fin_cand], dim=1)
        all_flags = torch.cat([finished_flags, eos_counts], dim=1)
        finished_scores, fin_idx = _top_k(all_scores, k)
        finished_seqs = _take(all_seqs, fin_idx)
        finished_flags = torch.gather(all_flags, 1, fin_idx)
        cur_len += 1

        # HF early stop: K hypotheses exist and the worst beats the best
        # alive candidate normalized at the current length.
        best_alive = alive_log_probs[:, 0] / (float(max(cur_len, 1)) ** length_penalty)
        worst_finished = finished_scores.min(dim=1).values
        done = done | (finished_flags.all(dim=1) & (worst_finished >= best_alive))

    # At a max-length exit the alive beams join the pool, normalized by the
    # generated length; rows already done stopped collecting.
    alive_final = torch.where(
        done[:, None], torch.full_like(alive_log_probs, NEG_INF),
        alive_log_probs / (float(max(cur_len, 1)) ** length_penalty))
    pool_seqs = torch.cat([finished_seqs, alive_seqs], dim=1)
    pool_scores = torch.cat([finished_scores, alive_final], dim=1)
    best = torch.argmax(pool_scores, dim=1)
    rows = torch.arange(b, device=pool_scores.device)
    # Drop the start token from the output.
    return pool_seqs[rows, best, 1:], pool_scores[rows, best]


def expand_to_beams(x: torch.Tensor, num_beams: int) -> torch.Tensor:
    """(B, ...) -> (B*K, ...) by repeating each row K times."""
    return x.repeat_interleave(num_beams, dim=0)


def greedy_decode_with_scores(decode_step: Callable, init_cache: Any,
                              batch_size: int, max_length: int,
                              min_new_tokens: int = 0, eos_token_id: int = 1,
                              pad_token_id: int = 0,
                              decoder_start_token_id: int = 0, device=None):
    """Greedy decoding that also returns every step's logits.

    Returns (sequences (B, max_length), scores (max_length, B, V) fp32). EOS
    is banned (its logit set to ``NEG_INF``, in the scores too) until
    ``min_new_tokens`` tokens precede it; a row that has emitted EOS emits
    pad from then on. Every one of the ``max_length`` steps runs, as in the
    JAX version, so that the scores of every step are the model's."""
    seqs = torch.full((batch_size, max_length + 1), pad_token_id,
                      dtype=torch.long, device=device)
    seqs[:, 0] = decoder_start_token_id
    done = torch.zeros((batch_size,), dtype=torch.bool, device=device)
    scores = []
    cache = init_cache
    for t in range(max_length):
        logits, cache = decode_step(cache, seqs[:, t:t + 1], t)
        logits = logits.float()
        if t < min_new_tokens:
            logits = logits.clone()
            logits[:, eos_token_id] = NEG_INF
        scores.append(logits)
        next_tok = torch.argmax(logits, dim=-1)
        next_tok = torch.where(done, torch.full_like(next_tok, pad_token_id),
                               next_tok)
        done = done | (next_tok == eos_token_id)
        seqs[:, t + 1] = next_tok
    return seqs[:, 1:], torch.stack(scores)
