"""RAM tagger, checkpoint-less form only (counterpart of the
`checkpoint_path is None` branch of
`instance_based_loc_tpu/models/ram.py:build_ram_tagger`).

Without a checkpoint the tagger returns no tags and the cascade falls back
to the caption ["object"]. RAM's Swin-L tagger itself (a checkpoint or
`random_init=True`) is not ported yet: asking for it raises instead of
returning no tags.
"""

from __future__ import annotations


def build_ram_tagger(checkpoint_path: str | None = None,
                     random_init: bool = False):
    """tagger(rgb) -> list[str], with `tagger.tag_batch(frames)`. Only the
    checkpoint-less tagger (no tags) exists in this package so far."""
    if checkpoint_path is not None or random_init:
        raise NotImplementedError(
            "RAM's Swin-L tagger is not ported yet (it is the next slice of "
            "the PyTorch port); build the cascade without a RAM checkpoint "
            "or pass explicit captions")

    def tagger(rgb):
        return []

    tagger.tag_batch = lambda frames: [[] for _ in frames]
    return tagger
