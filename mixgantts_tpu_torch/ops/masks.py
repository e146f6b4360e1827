"""Mask utilities (`mixgantts_tpu/ops/masks.py`): True = valid, everywhere."""

import torch


def sequence_mask(lengths, max_len):
    """[B] lengths -> [B, max_len] bool mask, True = valid position."""
    ids = torch.arange(max_len, device=lengths.device)[None, :]
    return ids < lengths[:, None].long()
