"""Modality frontend stubs (port of ``repro/models/frontend.py``).

The speech frontend (fbank + w2v-BERT) of seamless-m4t is external: the
encoder consumes precomputed frame embeddings ``(B, frames, d_model)``,
which :func:`audio_frame_embeddings` synthesizes.  Chameleon's image
content arrives as VQ token ids inside its vocabulary, which
:func:`vq_image_tokens` synthesizes.  Both draw from an explicit
``torch.Generator`` (the reference's draw from a ``jax.random`` key, which
torch cannot regenerate: feed both packages numpy draws to compare them).
"""
from __future__ import annotations

import torch


def vq_image_tokens(gen: torch.Generator, batch: int, n_patches: int,
                    vocab_size: int, image_token_offset: int = 8192, *,
                    device="cpu") -> torch.Tensor:
    """Stand-in for a VQ-VAE tokenizer: int32 ids in the image range
    ``[image_token_offset, vocab_size)``."""
    return torch.randint(image_token_offset, vocab_size, (batch, n_patches),
                         generator=gen, device=device, dtype=torch.int32)


def audio_frame_embeddings(gen: torch.Generator, batch: int, frames: int,
                           d_model: int, *, device="cpu") -> torch.Tensor:
    """Stand-in for the speech feature extractor: f32 normal draws times
    0.02, ``(batch, frames, d_model)``."""
    return torch.randn((batch, frames, d_model), generator=gen,
                       device=device, dtype=torch.float32) * 0.02
