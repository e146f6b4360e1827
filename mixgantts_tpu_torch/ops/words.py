"""Word/phoneme/frame sequence ops (`mixgantts_tpu/ops/words.py`), as
broadcast comparisons, batched products and gathers over duration cumsums.

- `word_level_pooling`  <- reference `utils/tools.py:394-413`
- `length_regulate`     <- reference `model/linguistic_encoder.py:383-416`
- `mapping_mask`        <- reference `model/linguistic_encoder.py:185-199`
- `rel_position_coef`   <- reference `model/linguistic_encoder.py:222-236`
"""

import torch


def segment_ids_from_counts(counts, out_len):
    """[B, W] per-segment counts -> [B, out_len] segment index of each
    position (positions past the total count get W)."""
    ends = torch.cumsum(counts.long(), dim=-1)                     # [B, W]
    pos = torch.arange(out_len, device=counts.device)[None, :, None]
    return (pos >= ends[:, None, :]).sum(dim=-1)


def word_level_pooling(x, counts, n_words, reduce="mean"):
    """x [B, P, H] phoneme features, counts [B, W] phones per word ->
    [B, n_words, H] word features (a one-hot [B, W, P] product)."""
    P = x.shape[1]
    seg = segment_ids_from_counts(counts, P)                        # [B, P]
    words = torch.arange(n_words, device=x.device)[None, :, None]
    one_hot = (seg[:, None, :] == words).to(x.dtype)                # [B, W, P]
    pooled = torch.bmm(one_hot, x)
    if reduce == "sum":
        return pooled
    if reduce == "mean":
        return pooled / torch.clamp(counts.to(x.dtype), min=1.0)[:, :, None]
    raise ValueError(reduce)


def length_regulate(x, durations, max_len):
    """x [B, W, H] word features, durations [B, W] frames per word ->
    (frames [B, max_len, H], mel_len [B]); frames past the total are 0."""
    seg = segment_ids_from_counts(durations, max_len)               # [B, T]
    mel_len = durations.long().sum(dim=-1)
    W, H = x.shape[1], x.shape[2]
    ids = torch.clamp(seg, 0, W - 1)
    frames = torch.gather(x, 1, ids[:, :, None].expand(-1, -1, H))
    valid = torch.arange(max_len, device=x.device)[None, :] < mel_len[:, None]
    return frames * valid[:, :, None].to(x.dtype), mel_len


def mapping_mask(dur_w, wb, n_frames, n_phones, n_words):
    """True where frame f and phoneme p belong to the same word."""
    frame_word = segment_ids_from_counts(dur_w, n_frames)           # [B, T]
    phone_word = segment_ids_from_counts(wb, n_phones)              # [B, P]
    same = frame_word[:, :, None] == phone_word[:, None, :]
    in_range = ((frame_word[:, :, None] < n_words)
                & (phone_word[:, None, :] < n_words))
    return same & in_range


def rel_position_coef(counts, out_len, valid_mask):
    """(p - segment_start) / max(segment_length, 1) at each position, 0 on
    padding."""
    counts = counts.long()
    seg = segment_ids_from_counts(counts, out_len)                  # [B, L]
    ids = torch.clamp(seg, 0, counts.shape[1] - 1)
    starts = torch.cumsum(counts, dim=-1) - counts
    seg_start = torch.gather(starts, 1, ids)
    seg_len = torch.gather(counts, 1, ids)
    pos = torch.arange(out_len, device=counts.device)[None, :]
    coef = (pos - seg_start).float() / torch.clamp(seg_len.float(), min=1.0)
    return coef * valid_mask.float()
