"""Compact embedded English synonym table for METEOR's synonym stage.

METEOR 1.5 resolves its synonym module through WordNet synsets
(meteor-1.5.jar's bundled synonym db — referenced by
pycocoevalcap/meteor/meteor.py:12 but not shipped, and neither WordNet nor
the jar is available in this zero-egress image). This module embeds a
hand-curated, captioning-domain-weighted subset of WordNet-style synonym
groups: two words match on the synonym stage iff they share at least one
group — the same share-a-synset predicate METEOR uses, over a much smaller
vocabulary. Coverage beyond this table is a documented deviation
(docs/PARITY.md); the table skews toward COCO caption vocabulary (objects,
scenes, people, spelling variants) where synonym matches actually occur.

Groups are sets of mutually substitutable single tokens (METEOR's synonym
module is also token-level). A word may appear in several groups
(e.g. "bike" ~ bicycle and motorcycle), exactly like polysemous WordNet
lemmas.

Users holding real WordNet data can install it at runtime with
``set_synonym_groups`` (both the Python and C++ scorers rebuild their
indices) — `metrics/ingest.py` provides a loader for the standard WordNet
Prolog ``wn_s.pl`` synset file, so true METEOR-1.5 synonym data is two
calls away::

    from show_and_tell_tpu_torch.metrics import ingest, synonyms
    synonyms.set_synonym_groups(ingest.load_wordnet_synsets("wn_s.pl"))
"""

from __future__ import annotations

from typing import Dict, FrozenSet, Tuple

SYNONYM_GROUPS: Tuple[Tuple[str, ...], ...] = (
    # --- people ---
    ("man", "men", "guy", "gentleman", "fellow", "gent", "bloke", "chap", "dude"),
    ("woman", "women", "lady", "gal", "dame"),
    ("boy", "lad"),
    ("girl", "lass", "missy"),
    ("person", "individual", "someone", "somebody", "mortal", "soul"),
    ("people", "folk", "folks"),
    ("kid", "child", "children", "youngster", "minor", "tyke", "tike"),
    ("infant", "baby", "babe"),
    ("adult", "grownup"),
    ("couple", "pair", "duo", "twosome"),
    ("trio", "threesome"),
    ("crowd", "throng"),
    ("group", "grouping"),
    ("cop", "policeman", "copper"),
    ("doctor", "doc", "physician"),
    # --- animals ---
    ("dog", "pooch", "doggie", "doggy"),
    ("cat", "kitty", "pussycat"),
    ("bunny", "rabbit"),
    # --- vehicles ---
    ("car", "auto", "automobile", "motorcar"),
    ("bicycle", "bike", "cycle"),
    ("motorcycle", "motorbike", "bike"),
    ("airplane", "aeroplane", "plane", "aircraft"),
    ("helicopter", "chopper", "copter", "whirlybird"),
    ("bus", "autobus", "omnibus", "motorbus", "coach"),
    ("truck", "lorry", "motortruck"),
    ("taxi", "cab", "taxicab"),
    ("train", "railcar"),
    ("subway", "metro", "underground", "tube"),
    ("boat", "watercraft"),
    ("sled", "sledge", "sleigh"),
    ("wagon", "waggon"),
    ("railway", "railroad"),
    # --- household / objects ---
    ("sofa", "couch", "lounge"),
    ("tv", "television", "telly"),
    ("refrigerator", "fridge", "icebox"),
    ("faucet", "tap", "spigot"),
    ("bathtub", "tub", "bath"),
    ("restroom", "bathroom", "lavatory", "toilet", "washroom", "loo"),
    ("closet", "wardrobe"),
    ("curtain", "drape", "drapery"),
    ("carpet", "rug", "carpeting"),
    ("stairs", "staircase", "stairway"),
    ("lamp",),
    ("photo", "photograph", "picture", "pic", "exposure"),
    ("image", "picture", "icon"),
    ("phone", "telephone"),
    ("cellphone", "mobile"),
    ("spectacles", "glasses", "eyeglasses", "specs"),
    ("bag", "handbag", "purse", "pocketbook"),
    ("suitcase", "bag", "grip"),
    ("luggage", "baggage"),
    ("backpack", "knapsack", "rucksack", "packsack", "haversack"),
    ("necktie", "tie"),
    ("hat", "chapeau", "lid"),
    ("glove", "mitt"),
    ("racket", "racquet"),
    ("scissors", "shears"),
    ("umbrella", "brolly"),
    # --- food / drink ---
    ("meal", "repast"),
    ("lunch", "luncheon"),
    ("dessert", "sweet", "afters"),
    ("cookie", "biscuit", "cooky"),
    ("pizza",),
    ("burger", "hamburger", "beefburger"),
    ("hotdog", "frankfurter", "frank", "wiener"),
    ("doughnut", "donut", "sinker"),
    ("beverage", "drink", "potable"),
    ("piece", "slice"),
    # --- places / scenery ---
    ("store", "shop"),
    ("market", "marketplace", "mart"),
    ("mall", "plaza"),
    ("cafe", "coffeehouse"),
    ("restaurant", "eatery"),
    ("bar", "pub", "saloon", "tavern"),
    ("home", "house"),
    ("building", "edifice"),
    ("bridge", "span"),
    ("fence", "fencing"),
    ("sidewalk", "pavement"),
    ("crosswalk", "crossing"),
    ("road", "route"),
    ("dock", "pier", "wharf"),
    ("harbor", "harbour", "seaport", "port", "haven"),
    ("forest", "wood", "woods"),
    ("mountain", "mount"),
    ("stream", "creek", "brook"),
    ("shore", "coast", "seacoast"),
    ("flower", "bloom", "blossom"),
    ("bush", "shrub"),
    ("foliage", "leafage", "leaf"),
    ("rock", "stone"),
    ("garbage", "trash", "rubbish", "refuse", "waste"),
    ("pile", "heap", "mound", "stack"),
    ("bunch", "clump", "cluster"),
    # --- time of day ---
    ("night", "nighttime", "dark"),
    ("day", "daytime", "daylight"),
    ("evening", "eve", "eventide"),
    ("morning", "morn", "forenoon"),
    ("sunset", "sundown"),
    ("sunrise", "sunup", "dawn", "daybreak"),
    # --- adjectives ---
    ("big", "large"),
    ("small", "little"),
    ("huge", "immense", "vast"),
    ("enormous", "tremendous"),
    ("tiny", "diminutive", "petite", "midget"),
    ("quick", "fast", "speedy", "rapid"),
    ("happy", "glad"),
    ("sad", "unhappy"),
    ("near", "close"),
    ("damp", "moist"),
    ("dirty", "soiled", "unclean"),
    ("shiny", "glossy", "lustrous", "sheeny", "shining"),
    ("elderly", "aged"),
    ("center", "centre", "middle"),
    # --- verbs / actions (conservative: synset-faithful pairs only) ---
    ("talk", "speak"),
    ("begin", "start", "commence"),
    ("end", "finish", "conclude"),
    ("jump", "leap", "bound", "spring"),
    ("shout", "yell", "scream", "holler"),
    ("smile", "grin"),
    # --- US/UK spelling variants (METEOR's synonym db also bridges these) ---
    ("color", "colour"),
    ("colored", "coloured"),
    ("colorful", "colourful"),
    ("gray", "grey"),
    ("theater", "theatre"),
    ("neighbor", "neighbour"),
    ("mustache", "moustache"),
    ("pajamas", "pyjamas"),
    ("tire", "tyre"),
    ("curb", "kerb"),
    ("plow", "plough"),
    ("ax", "axe"),
    ("barbecue", "barbeque", "bbq"),
)


_ACTIVE_GROUPS: Tuple[Tuple[str, ...], ...] = SYNONYM_GROUPS
_GENERATION = 0  # bumped on table swap so scorers can rebuild caches


def set_synonym_groups(groups) -> None:
    """Replace the active synonym table (e.g. with real WordNet synsets via
    ``ingest.load_wordnet_synsets``). ``groups``: iterable of iterables of
    single-token words. Multi-token entries are rejected (METEOR's synonym
    module is token-level); single-member groups are dropped (they can never
    produce a match). Mirrors ``paraphrases.set_paraphrase_groups``."""
    global _ACTIVE_GROUPS, _GENERATION
    canon = []
    for g in groups:
        row = tuple(dict.fromkeys(w.strip() for w in g))  # dedup, keep order
        for w in row:
            if not w or len(w.split()) != 1:
                raise ValueError(f"synonym entry {w!r} is not a single token")
        if len(row) >= 2:
            canon.append(row)
    _ACTIVE_GROUPS = tuple(canon)
    _GENERATION += 1


def active_groups() -> Tuple[Tuple[str, ...], ...]:
    return _ACTIVE_GROUPS


def generation() -> int:
    return _GENERATION


def build_index() -> Dict[str, FrozenSet[int]]:
    """word -> frozen set of group ids over the ACTIVE table (a word may be
    in several groups).

    Each table word is indexed under its surface form AND its Porter stem,
    and lookups union both keys (metrics/meteor.py) — a cheap stand-in for
    WordNet's morphological lookup so inflected forms ('kids', 'bikes',
    'jumping') still reach their groups."""
    from show_and_tell_tpu_torch.metrics.meteor import porter_stem

    tmp: Dict[str, set] = {}
    for gid, group in enumerate(_ACTIVE_GROUPS):
        for w in group:
            tmp.setdefault(w, set()).add(gid)
            tmp.setdefault(porter_stem(w), set()).add(gid)
    return {w: frozenset(g) for w, g in tmp.items()}


def serialize() -> bytes:
    """One group per line, words space-separated — the wire format consumed
    by the C++ scorer's ``meteor_set_synonyms`` so both implementations
    share one table (always the ACTIVE table)."""
    return "\n".join(" ".join(g) for g in _ACTIVE_GROUPS).encode()
