"""Caption filtering for the perception cascade.

The behavioural contract comes from reference
`object_memory/object_finder_phrases.py`: RAM's open-set tags are filtered
against an ignore list (structural/abstract words) and a substring list
before being fed to the grounding detector, and `check_if_floor` routes
floor-like instances into the dedicated floor accumulator
(`object_memory.py:248-256`). The word lists are data, reproduced as-is
(including the reference's dataset-specific commented toggles) because
changing them changes which objects enter memory.
"""

from __future__ import annotations

FLOOR_WORDS = (
    "floor",
    "ground",
    "earth",
    # dataset-specific toggles kept from the reference (commented for TUM desk):
    # "table", "chair", "desk", "desktop", "counter",
)

IGNORE_WORDS = frozenset({
    "garage", "workshop", "warehouse", "basement",
    "parking garageelevator",  # sic: reference list has a missing comma
    "equipment", "cardboard", "living room", "ceiling", "room", "curtain",
    "den", "window", "floor", "wall", "red", "yellow", "white", "blue",
    "green", "brown", "corridor", "image", "picture frame", "mat",
    "wood floor", "shadow", "hardwood", "plywood", "waiting room", "lead to",
    "belly", "person", "chest", "black", "accident", "act", "door", "doorway",
    "illustration", "animal", "mountain", "table top", "pen", "pencil",
    "corner", "notepad", "flower", "man", "pad", "lead", "ramp", "plank",
    "scale", "beam", "pink", "tie", "crack", "mirror", "square", "rectangle",
    "woman", "tree", "umbrella", "hat", "salon", "beach", "open", "closet",
    "blanket", "circle", "furniture", "balustrade", "cube", "dress", "ladder",
    "briefcase", "marble", "pillar", "dark", "sea", "cabinet", "office",
})

IGNORE_SUBPHRASES = (
    "room", "floor", "wall", "frame", "image", "building",
    "ceilinglead",  # sic: reference list has a missing comma
    "paint", "shade", "snow", "rain", "cloud", "frost", "fog", "sky",
    "carpet", "view", "scene", "mat", "window", "vase", "bureau", "computer",
    "cubicle", "supply", "sit", "stall", "fan", "cabinet", "job", "garage",
    # dataset-specific toggles kept from the reference (commented for TUM desk):
    # "box", "stuff", "table", "chair", "desk", "desktop", "counter",
)


def filter_caption(caption: list[str]) -> list[str]:
    """Drop ignored words / substring matches (object_finder_phrases.py:1-17)."""
    out = []
    for word in caption:
        w = word.strip()
        if w in IGNORE_WORDS:
            continue
        if any(sub in w for sub in IGNORE_SUBPHRASES):
            continue
        out.append(w)
    return out


def check_if_floor(texts) -> bool:
    """True if any name marks the instance as floor/ground
    (object_finder_phrases.py:19-35)."""
    return any(word in texts for word in FLOOR_WORDS)
