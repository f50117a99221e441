"""Built-in SPICE backend: rule-based scene-graph parsing + tuple F-score.

The reference's SPICE (pycocoevalcap/spice/spice.py:63-91) shells out to
``spice-1.0.jar``, which parses captions into scene graphs with the Stanford
dependency parser + SceneGraphParser and scores the F1 overlap of semantic
tuples. The jar is absent from the reference repo, so SPICE never actually
ran there. This module is a dependency-free equivalent built for caption
English:

- **Parser**: a closed-class-lexicon chunker tuned to caption grammar
  ("DT ADJ* NOUN (VERB) (PREP DT ADJ* NOUN)*"). It emits SPICE's three tuple
  kinds: objects ``(head,)``, attributes ``(head, attr)``, and relations
  ``(subj, rel, obj)``. Not a CoreNLP-parity parser — a documented
  approximation (docs/PARITY.md) that covers the constructions COCO captions
  are made of.
- **Scoring**: exactly SPICE's definition (Anderson et al. 2016 §3): the
  reference scene graph is the UNION of tuples over all reference captions;
  P = |T_c matched| / |T_c|, R = |T_c matched| / |T_r|, F = 2PR/(P+R).
  Tuple elements match on equal Porter lemmas or shared synonym group
  (metrics/synonyms.py) — the stand-in for SPICE's WordNet synset matching.

Install as the SPICE backend via ``spice.use_builtin_backend()`` (done by
default on import of metrics.spice).
"""

from __future__ import annotations

import functools

from typing import Dict, FrozenSet, List, Sequence, Set, Tuple

import numpy as np

from show_and_tell_tpu_torch.metrics.meteor import porter_stem, _syn_groups

from show_and_tell_tpu_torch.metrics.scene_lexicon import (  # noqa: F401
    DETERMINERS, NUMBERS, _DIGIT_WORDS, _MODALS,
    _RAISING_VERBS, _PHRASAL_VERBS, _PHRASAL_BARE, _ANAPHORS,
    _EVENT_ING, _LIST_DETS, _S_ATTRIBUTIVE, _LIST_NOUNS,
    _FRONT, PREPOSITIONS, COPULAS, CONJUNCTIONS,
    SKIP, SUBORDINATORS, Tuple3, POST_ADJS,
    NON_AGENT, PLACE_NOUNS, CONTAINER_NOUNS, _CONTAINER_NORMED,
    _SPANNING_NORMED, _BENEFACTIVE_AGENT_NORMED, _LAMP_PREMODS, _PLACEMENT_NORMED,
    FRAMING_PARTICIPLES, ASPECTUAL_VERBS, LIGHT_VERBS, _GET_FORMS,
    _EXEMPLAR, _VAGUE_LARGE, _FIT_FORMS, _DITRANS,
    _DITRANS_EVENT, _IRREGULAR_NOUNS, ING_NOUNS, ED_NOUNS,
    VERBS, MOTION_PREPS, MATERIAL_NOUNS, AMBIENT_NOUNS,
    EVENT_NOUNS, RIDEABLE_NOUNS, TOOL_NOUNS, BODY_PART_NOUNS,
    AGGREGATE_OF_NOUNS, QUALITY_OF_NOUNS, _AGENT_ING, _THEME_MOTION,
    _STATIVE_COVER, _THEME_NORMED, _PROJECTED_NOUNS, _DEPICTION_NOUNS,
    _ENCLOSURE_PARTICIPLES, _GOAL_NORMED, _STATIVE_NORMED, _TRANSFORM_NORMED,
    _MOUNT_NORMED, COLOR_WORDS, SIZE_WORDS, PRED_ADJS,
    _DEGREE_ADJS, _INF_MANNER_ADVERBS, ANIMATE_NOUNS, ADJ_COORD,
    _PRED_ADJ_SET, S_NOUN_AFTER_CONJ, _S_NOUN_OBJECT_ONLY, _TRANS_OBJ,
    _SPORT_PREMODS, _SPORT_TAILS, _COMPOUND_PREPS, _INF_TO,
    _OUT_OF, _BARE_TO_ING, _LOOK_VERBS, _UP_MOTION_VERBS,
    PARTICIPLE_BASE, FINITE_NOT_PARTICIPLE, STRICT_PARTICIPLES, COMPOUND_PREMODIFIERS,
)


def _norm(word: str) -> str:
    if word == _FRONT:  # sentinel -> surface relation word in tuples
        return "front"
    if word == "left_of":  # "to the left of" collapse -> relation 'left'
        return "left"
    if word == "right_of":
        return "right"
    if word in ("one", "ones"):
        # Porter stems "one" -> "on", colliding with the preposition, and
        # "ones" -> "one", splitting the two forms apart; pin both to the
        # lemma (anaphoric heads — "a smaller ONE" — and count attributes
        # share it)
        return "one"
    return porter_stem(_IRREGULAR_NOUNS.get(word, word))


class _NP:
    __slots__ = ("head", "attrs", "poss", "det")

    def __init__(self, head: str, attrs: List[str]):
        self.head = head
        self.attrs = attrs
        # opened by a back-referring possessive determiner ("its lid"):
        # the NP is a PART of the clause subject, so a locative after it
        # re-anchors ("a toilet with ITS LID up in a bathroom" — the
        # toilet is in the bathroom, not the lid). Set by close_np.
        self.poss = False
        # opened by ANY determiner ("a knife", "his umbrella", "two
        # forks"): bare plurals/mass nouns (det=False) read as
        # furnishings of the nearest noun, determined NPs can be carried
        # instruments — same split the prep-site carried-object rule
        # makes on its lookahead token. Set by _flush_np.
        self.det = False


def _flush_np(words: List[str]) -> _NP | None:
    """[det]* [mod]* head -> NP(head, attrs). Number words become count
    attributes; other pre-head content words become attributes."""
    content = [w for w in words if w not in DETERMINERS or w in NUMBERS]
    content = [w for w in content if w not in SKIP]
    if not content:
        return None
    # post-nominal adjectives are attributes, never the head ("a bowl full")
    post: List[str] = []
    while len(content) >= 2 and content[-1] in POST_ADJS:
        post.append(content.pop())
    head = content[-1]
    attrs = content[:-1] + post
    np_ = _NP(head, attrs)
    np_.det = bool(words) and words[0] in DETERMINERS
    return np_





def _ed_verb(w: str) -> bool:
    """Morphological -ed verb test. Length 4 admits "tied"/"iced"-class
    participles; the -eed noun family (seed/reed/weed/...) and the
    ED_NOUNS exceptions stay nominal."""
    return (
        len(w) > 3
        and w.endswith("ed")
        and not w.endswith("eed")
        and w not in ED_NOUNS
    )


def _is_verbish(w: str) -> bool:
    if len(w) > 4 and w.endswith("ing") and w not in ING_NOUNS:
        return True
    if _ed_verb(w):
        return True
    return w in VERBS or w in PARTICIPLE_BASE


def _is_participle(w: str) -> bool:
    """Past participles only — the forms that make a 'by'-phrase passive.
    A gerund before 'by' is locative ("a dog sitting BY the door"), never
    inverted."""
    return w in PARTICIPLE_BASE or _ed_verb(w)


def _content_word(t: str) -> bool:
    return (t not in DETERMINERS or t in NUMBERS) and t not in SKIP


def _licensed_participle(t: str) -> bool:
    return t in STRICT_PARTICIPLES or (
        _is_participle(t) and t not in FINITE_NOT_PARTICIPLE
    )


def _object_compound_tail(words: Sequence[str], k: int) -> bool:
    """words[k] is a compound participle INSIDE an object NP: a number/
    premodifier run separates it from an earlier verb, and a bare head
    follows ("a man HOLDING two PARKED cars" — parked modifies cars;
    holding is the clause verb). Caller guarantees the right side of k is
    verb-free — blind-7 audit."""
    if not (
        _licensed_participle(words[k])
        # a gerund directly preceded by a NUMBER word is attributive too
        # ("holding ONE SLEEPING baby", "watching TWO BARKING dogs") — a
        # number can never be a gerund clause's subject; non-number
        # subjects keep the clause reading ("a giraffe EATING leaves")
        # — fix (the blind-7 number-subject rule had covered only
        # participles)
        or (
            words[k].endswith("ing")
            and _is_verbish(words[k])
            and k >= 1
            and words[k - 1] in NUMBERS
        )
    ):
        return False
    j, seen_premod = k - 1, False
    while j >= 0 and (
        not _content_word(words[j])
        or words[j] in NUMBERS
        or words[j] in ADJ_COORD
        or words[j] in COMPOUND_PREMODIFIERS
    ):
        if _content_word(words[j]):
            seen_premod = True
        j -= 1
    return seen_premod and j >= 0 and _is_verbish(words[j])


def _compound_right_side(words: Sequence[str], k: int) -> bool:
    """The right side of a split at k is a single NP even though it
    contains verbish tokens: every one is a licensed participle preceded
    only by number/premodifier content, with a bare head after the last
    ("holding TWO PARKED CARS"). Caller guarantees at least one verbish
    token on the right — blind-7 audit."""
    right = words[k + 1 :]
    vpos = [m for m, t in enumerate(right) if _is_verbish(t)]
    if not all(
        _licensed_participle(right[m])
        # number-licensed attributive gerund ("holding ONE SLEEPING
        # baby") — the twin of the _object_compound_tail extension
        or (
            right[m].endswith("ing")
            and m >= 1
            and right[m - 1] in NUMBERS
        )
        for m in vpos
    ):
        return False
    lead = [t for t in right[: vpos[0]] if _content_word(t)]
    if not lead or not all(
        t in NUMBERS or t in ADJ_COORD or t in COMPOUND_PREMODIFIERS
        for t in lead
    ):
        return False
    return any(_content_word(t) for t in right[vpos[-1] + 1 :])


def _as_finite_clause(toks: Sequence[str], ti: int) -> bool:
    """'as' introducing a finite clause ("a crowd watches AS a man rides a
    bull"): a determiner follows and a FINITE verb appears before any
    prep/conjunction/copula. Gerunds and participles do NOT count — "a
    man dressed as a clown JUGGLING balls" is role syntax plus a reduced
    relative, not a clause, so 'as' stays skipped there (fix: the
    first cut accepted any verbish token and dropped the role relation).

    The subject may be a det-less mass/plural noun ("a boat sails AS
    SMOKE RISES behind it") — any non-verb content word opens the
    candidate clause; the finite-verb requirement still rejects det-less
    role syntax ("dressed as cowboys RIDING horses") — blind-9 finding."""
    if ti + 1 >= len(toks):
        return False
    if toks[ti + 1] not in DETERMINERS and not (
        _content_word(toks[ti + 1]) and not _is_verbish(toks[ti + 1])
    ):
        return False
    for t in toks[ti + 2 : ti + 7]:
        if t in PREPOSITIONS or t in CONJUNCTIONS or t in COPULAS:
            return False
        if _is_verbish(t):
            return not t.endswith("ing") and not _is_participle(t)
    return False


def _nounish(w: str) -> bool:
    """Token that can end an NP — used by the asyndetic-list rewrite to
    recognize a determiner-to-determiner juncture."""
    return (
        w.isalpha()
        and w not in PREPOSITIONS
        and w not in CONJUNCTIONS
        and w not in COPULAS
        and w not in DETERMINERS
        and w not in SKIP
        and w not in SUBORDINATORS
        and not _is_verbish(w)
    )


@functools.lru_cache(maxsize=1 << 15)
def parse(caption: str) -> FrozenSet[Tuple3]:
    """PTB-tokenized lowercase caption -> frozenset of scene-graph tuples.

    Cached: periodic checkpoint evaluation re-scores against the SAME
    reference captions every time, so the parse of the whole val reference
    set amortizes to one pass. The frozen return type keeps cache entries
    immutable.

    Segmentation walks the token stream: determiners open a new NP,
    prepositions/copulas/conjunctions close the current one, gerunds are
    verb/relation candidates ("a man RIDING a horse" -> relation; "dogs
    RUNNING on the beach" -> attribute + preposition relation). All tuple
    elements are Porter-normalized so candidate/reference graphs built by
    this same parser align on lemmas.
    """
    # "n't" survives the filter: PTB splits "isn't" -> "is n't" and the
    # metric pipeline's punctuation strip does not remove it, so contracted
    # negation must reach the negation handler below. Digit tokens are
    # count attributes (SPICE keeps cardinality): 1-10 normalize to their
    # word forms so "2 dogs" and "two dogs" build the SAME tuple; larger
    # numerals stay as-is and become plain count attributes
    toks = [
        _DIGIT_WORDS.get(t, t) for t in caption.split()
        if t.isalpha() or t.isdigit() or t in COPULAS or t == "n't"
    ]
    # collapse compound prepositions ("on top of" -> "on")
    out: List[str] = []
    i = 0
    while i < len(toks):
        for pat, rep in _COMPOUND_PREPS:
            if tuple(toks[i : i + len(pat)]) == pat:
                if rep is not None:
                    out.append(rep)
                i += len(pat)
                break
        else:
            out.append(toks[i])
            i += 1
    toks = out

    # where-relative: "a PARK where children are playing" locates the
    # clause's subject IN the head NP ((children, in, park)), so the
    # caption reorders to the plain clause the machinery already models
    # ("children are playing in a park"). Scoped to a caption-initial
    # head NP (dets/attrs/noun only) with a real clause after "where" —
    # blind-13 finding
    if "where" in toks:
        k = toks.index("where")
        if (
            1 <= k <= 4
            and all(
                not _is_verbish(t)
                and t not in PREPOSITIONS
                and t not in COPULAS
                and t not in CONJUNCTIONS
                for t in toks[:k]
            )
            and any(_is_verbish(t) or t in COPULAS for t in toks[k + 1 :])
        ):
            toks = toks[k + 1 :] + ["in"] + toks[:k]

    # drop modal auxiliaries before (optionally negated) "be" and
    # raising-verb "to" bigrams — see _MODALS / _RAISING_VERBS above
    out = []
    i = 0
    whose_pending = False  # "whose" rewrite awaits its embedded copula
    from_one_noun = None  # "from one X" awaiting its "to another" endpoint
    while i < len(toks):
        w = toks[i]
        nxt = toks[i + 1] if i + 1 < len(toks) else None
        nxt2 = toks[i + 2] if i + 2 < len(toks) else None
        if w in ("to", _INF_TO) and nxt in _BARE_TO_ING:
            # infinitival context: the bare ambiguous verb is marked as a
            # verb by rewriting to its -ing form (same stem)
            toks[i + 1] = _BARE_TO_ING[nxt]
            nxt = toks[i + 1]
        if w == _OUT_OF:
            # always prepositional; falls through (instead of appending
            # directly) so the anaphor rule below still sees it and
            # "jumping out of it" drops like any other prep+pronoun
            w = "out"
        elif w == "out" and not (out and out[-1] in _LOOK_VERBS):
            # bare "out" is a particle/adverb everywhere except after a
            # look-type verb ("looking OUT the window" keeps its locative)
            i += 1
            continue
        elif w == "up" and not (
            out
            and out[-1] in _UP_MOTION_VERBS
            and nxt is not None
            and (nxt in DETERMINERS or _nounish(nxt))
        ):
            # bare "up" is a particle/adverb except after a motion verb
            # with a following NP ("walking UP the stairs" keeps its
            # path; "HOLDING UP an umbrella" drops it)
            i += 1
            continue
        # degree adverbs carry no scene content ("a glass NEARLY full of
        # orange juice" -> (glass, full)) — blind-13 finding
        if w in ("nearly", "almost"):
            i += 1
            continue
        # vague large quantifiers pass through to their of-object
        # ("DOZENS OF seagulls flying" -> the seagulls fly) — blind-13
        if w in _VAGUE_LARGE and nxt == "of":
            i += 2
            continue
        # "one of several/many X" is a vague partitive: pass through to
        # the plural head, which keeps its verbs and locatives ("ONE OF
        # SEVERAL boats docked at a pier" -> (boats, docked)) — blind-13
        if (
            w == "one"
            and nxt == "of"
            and nxt2 in ("several", "many")
            and i + 3 < len(toks)
            and _content_word(toks[i + 3])
        ):
            i += 3
            continue
        # temporal subordination over a gerund is VP coordination on the
        # matrix subject ("a man resting AFTER FINISHING a race" -> the
        # man rests and finishes) — 'after' itself emits nothing;
        # after/before with an NP object stay prepositions — blind-13
        if (
            w in ("after", "before")
            and nxt is not None
            and nxt.endswith("ing")
            and _is_verbish(nxt)
        ):
            out.append("and")
            i += 1
            continue
        # "fit(s) in/into" is a light locative: the verb drops and the
        # preposition anchors to the subject — blind-13 finding
        if w in _FIT_FORMS and nxt in ("in", "into", "inside"):
            i += 1
            continue
        # "set up" in verb position is the arrangement participle
        # ("umbrellas of different colors SET UP on a beach" ->
        # (umbrellas, set)); the -ing rewrite marks it as a verb for the
        # segmentation (same stem after Porter). A determiner before
        # keeps the noun reading ("a chess SET") — blind-13 finding
        if (
            w == "set"
            and nxt == "up"
            and out
            and out[-1] not in DETERMINERS
            and out[-1] not in PREPOSITIONS
        ):
            out.append("setting")
            i += 2
            continue
        # "too ADJ to VERB" is an UNREALIZED infinitive: the adjective
        # predicates the subject and the infinitive emits nothing, its
        # object surviving as a bare entity ("a box TOO HEAVY TO LIFT"
        # -> (box, heavy); "a boy too short to reach THE COUNTER" ->
        # (boy, short) + (counter,)) — blind-13 finding. The adjective
        # slot also admits degree-frame state adjectives and participial
        # adjectives ("too EXCITED to sit"), and a trailing manner adverb
        # is swallowed with the infinitive ("to sit STILL") — blind-14
        # coverage fix
        if (
            w == "too"
            and (
                ((nxt in _PRED_ADJ_SET or nxt in _DEGREE_ADJS)
                 and not _is_verbish(nxt))
                or (_is_participle(nxt) and not nxt.endswith("ing"))
            )
            and nxt2 == "to"
            and i + 3 < len(toks)
            and _is_verbish(toks[i + 3])
        ):
            out.extend(["is", nxt])
            i += 4
            while i < len(toks) and toks[i] in _INF_MANNER_ADVERBS:
                i += 1
            if i < len(toks) and toks[i] not in CONJUNCTIONS:
                out.append("and")  # detach the unrealized verb's object
            continue
        # "as ADJ as NP" comparative: the adjective predicates the
        # subject; the standard of comparison is its own entity with its
        # own attributes ("a dog AS BIG AS a small horse" -> (dog, big)
        # + (horse, small)) — blind-13 finding
        if (
            w == "as"
            and nxt in _PRED_ADJ_SET
            and not _is_verbish(nxt)
            and nxt2 == "as"
        ):
            out.extend(["is", nxt, "and"])
            i += 3
            continue
        # "so ADJ (that) (it/they)" result clause: the adjective
        # predicates the subject and the result clause's anaphoric
        # subject IS the matrix subject, so it rewrites to VP
        # coordination ("a kite flying SO HIGH THAT IT looks like a dot"
        # -> (kite, high) + (kite, looks) + (kite, like, dot)) —
        # blind-13 finding
        if w == "so" and nxt in _PRED_ADJ_SET and not _is_verbish(nxt):
            j = i + 2
            if j < len(toks) and toks[j] == "that":
                j += 1
            if j < len(toks) and toks[j] in ("it", "they", "he", "she"):
                j += 1
            if j < len(toks) and (
                _is_verbish(toks[j])
                or toks[j] in COPULAS
                or toks[j] in _FIT_FORMS
            ):
                if not (out and _is_verbish(out[-1])):
                    out.append("is")
                out.extend([nxt, "and"])
                i = j
                continue
            i += 1  # bare "so ADJ": degree word drops
            continue
        # bare degree "so"/"too" outside the comparative frames above
        # carries no scene content ("carrying TOO many bags", "a table
        # with SO many plates" — the quantifier machinery handles the
        # rest) — blind-13 finding: 'too' had become a verb
        # OBJECT ((man, carry, too))
        if w in ("too", "so"):
            i += 1
            continue
        # possessive relative: "a man WHOSE shirt is covered in paint" ->
        # (man, have, shirt) with the part as the embedded clause's
        # subject — rewritten onto the possessive-have + relativizer
        # machinery ("a man THAT HAS a shirt THAT is covered...");
        # whose_pending inserts the second relativizer at the next
        # copula — blind-13 finding
        if w == "whose":
            out.extend(["that", "has", "a"])
            whose_pending = True
            i += 1
            continue
        if (
            whose_pending
            and (w in COPULAS or _is_verbish(w))
            and out
            and _nounish(out[-1])
        ):
            # the part NP is complete (a noun precedes): bind the
            # embedded predicate to it — copular ("whose shirt IS
            # covered") and finite ("whose dog RUNS in a park") alike;
            # an attributive participle inside the part NP ("whose
            # PAINTED fence...") has no noun before it yet, so the
            # insert waits — blind-13
            out.append("that")
            whose_pending = False
            # fall through: the verb/copula itself is processed below
        # negative existential: "THERE ARE NO cars parked on the street"
        # denies the VP and its locative but keeps the entities —
        # reordered onto the clause-negation machinery ("cars NOT parked
        # on the street" -> (cars,) + (street,)) — blind-13 finding
        if w == "there" and nxt in COPULAS and nxt2 == "no":
            j = i + 3
            while j < len(toks) and not (
                _is_verbish(toks[j])
                or toks[j] in PREPOSITIONS
                or toks[j] in COPULAS
                or toks[j] in CONJUNCTIONS
            ):
                out.append(toks[j])
                j += 1
            if j < len(toks):
                out.append("not")
            i = j
            continue
        # "from one X to another (X)" / "from one X ... to the other":
        # a path over two instances of the same entity class — 'one' is
        # the determiner half of the one/another pair, not a count ("a
        # train traveling FROM ONE STATION TO ANOTHER" -> (train, from,
        # station) + (train, to, station)). The 'from' half records the
        # noun; the anaphoric endpoint restores it — blind-13 finding
        if (
            w == "from"
            and nxt == "one"
            and nxt2 is not None
            and _nounish(nxt2)
        ):
            for j in range(i + 3, len(toks) - 1):
                if toks[j] != "to":
                    continue
                # the endpoint must be ANAPHORIC — the same not-_nounish
                # lookahead the to-site consumption applies ("from one
                # station TO ANOTHER CITY" is two different entities, not
                # the one/another pair; committing the rewrite there would
                # leave from_one_noun armed for the rest of the caption) —
                # advisor r3 finding
                if (
                    toks[j + 1] == "another"
                    and (j + 2 >= len(toks) or not _nounish(toks[j + 2]))
                ) or (
                    toks[j + 1] == "the"
                    and j + 2 < len(toks)
                    and toks[j + 2] == "other"
                    and (j + 3 >= len(toks) or not _nounish(toks[j + 3]))
                ):
                    out.extend(["from", nxt2])
                    from_one_noun = nxt2
                    break
            else:
                out.append(w)  # plain count: "a view FROM ONE window"
                i += 1
                continue
            i += 3
            continue
        if from_one_noun is not None and w == "to" and (
            (
                nxt == "another"
                and (nxt2 is None or not _nounish(nxt2))
            )
            or (
                nxt == "the"
                and nxt2 == "other"
                and (i + 3 >= len(toks) or not _nounish(toks[i + 3]))
            )
        ):
            out.extend(["to", from_one_noun])
            i += 2 if nxt == "another" else 3
            from_one_noun = None
            continue
        # perfect auxiliary: "has (just) hit a ball", "has been made",
        # "has not been made" — the have-form carries no scene content and
        # must not become a possession relation. Skip light adverbs, then:
        # a following participle/"been" marks the auxiliary (drop it; the
        # copula/participle machinery handles the rest); "not been" is
        # reordered to the copula-first form the negation handler models
        # ("been not made", like the modal rewrite above). A following
        # NOUN keeps the possession reading ("a pizza that HAS mushrooms").
        # Blind-9 finding.
        if w in ("has", "have", "had"):
            j = i + 1
            while j < len(toks) and toks[j] in (
                "just", "already", "recently", "finally"
            ):
                j += 1
            nt = toks[j] if j < len(toks) else None
            nt2 = toks[j + 1] if j + 1 < len(toks) else None
            if nt in ("not", "n't") and nt2 == "been":
                out.extend(["been", nt])
                i = j + 2
                continue
            if nt == "been" or (
                nt is not None
                and _is_participle(nt)
                and nt not in FINITE_NOT_PARTICIPLE
                # an ATTRIBUTIVE participle — followed by a bare content
                # noun, no determiner — keeps the possession reading ("a
                # pizza that has MELTED CHEESE" -> (pizza, have, cheese)
                # + (cheese, melt); the aux reading needs a determined
                # object: "has just hit A ball") — adversarial-test
                # refinement of the blind-9 aux drop
                and not (
                    nt2 is not None
                    and _content_word(nt2)
                    and not _is_verbish(nt2)
                    and nt2 not in DETERMINERS
                    and nt2 not in PREPOSITIONS
                    and nt2 not in CONJUNCTIONS
                )
            ):
                i = j
                continue
        # get-passive auxiliary: "a man GETTING hit by a wave" — the
        # get-form before a bare participle is pure passive voice, like
        # "being"; dropping it lets the existing by-passive machinery
        # produce the active-aligned tuple ((wave, hit, man), with no
        # junk (man, get) attribute). Followed by anything else the verb
        # reading survives ("people GETTING on" keeps its pinned
        # (people, getting) attribute; "getting ready to" collapsed
        # earlier) — blind-11 finding
        if w in ("getting", "gets", "get", "got"):
            j = i + 1
            while j < len(toks) and toks[j] in (
                "just", "already", "recently", "finally"
            ):
                j += 1
            nt = toks[j] if j < len(toks) else None
            if (
                nt is not None
                and not nt.endswith("ing")
                and _is_participle(nt)
                and nt not in FINITE_NOT_PARTICIPLE
            ):
                i = j
                continue
        if w in _MODALS and nxt == "be":
            i += 1  # "be" flows through
            continue
        if w in _MODALS and nxt in ("not", "n't") and nxt2 == "be":
            # reorder to the finite surface form the negation handler
            # models ("can not be seen" -> "be not seen", like "is not
            # seen") so negated modal passives suppress the VP too
            out.extend(["be", nxt])
            i += 3
            continue
        if w in _RAISING_VERBS and nxt == "to":
            i += 2
            continue
        # bare-adjective raising: "a box that SEEMS (TOO) HEAVY" is the
        # copular predication "is heavy" — the raising verb and the
        # degree word carry no scene content — blind-13 finding
        if w in _RAISING_VERBS:
            j = i + 1
            if j < len(toks) and toks[j] == "too":
                j += 1
            if j < len(toks) and (
                (toks[j] in _PRED_ADJ_SET and not _is_verbish(toks[j]))
                # open-class predicate adjective ("a dog that SEEMS
                # HAPPY"): any noun-like token NOT followed by another
                # noun-like token (a real NP object would be) reads
                # predicative — blind-13 finding
                or (
                    _nounish(toks[j])
                    and (
                        j + 1 >= len(toks) or not _nounish(toks[j + 1])
                    )
                )
            ):
                out.append("is")
                i = j  # the adjective itself is processed next
                continue
        # the bare-form guard reads the stream BEFORE this pass's own
        # drops (toks[i-1], which may be the _INF_TO sentinel left by the
        # preparatory-aspect collapse): an infinitive is active voice, so
        # "ready to put ON a coat" drops its particle while the reduced
        # relative "food put ON a plate" keeps its locative
        if nxt in ("on", "off") and (
            w in _PHRASAL_VERBS
            or (
                w in _PHRASAL_BARE
                and i > 0
                and toks[i - 1] in ("to", _INF_TO)
            )
        ):
            out.append(w)  # keep the verb, drop its particle
            i += 2
            continue
        if w == _INF_TO:
            i += 1
            continue
        # "light up" / "lights up" in verb position (no determiner before
        # the token) is the phrasal verb: rewrite to the gerund the clause
        # machinery already models ("watching fireworks LIGHT UP the sky"
        # -> the fireworks light the sky; _norm('lighting') == 'light',
        # matching the finite phrasing). A determiner keeps the noun
        # reading ("a LIGHT up ahead") — blind-9 finding. The verb reading
        # further needs (a) no lamp-compound premodifier before ("STREET
        # lights up and down the road", "CHRISTMAS lights up on the roof"
        # are compound nouns) and (b) a real OBJECT after "up" — a
        # preposition/conjunction/bare adverbial there means the "up" is
        # locative, not the phrasal particle ("lights up ON the roof",
        # "lights up AND down", "lights up AHEAD") — adversarial-test
        # refinement
        if (
            w in ("light", "lights")
            and nxt == "up"
            and (not out or out[-1] not in DETERMINERS)
            and (not out or out[-1] not in _LAMP_PREMODS)
            and i + 2 < len(toks)
            and (
                toks[i + 2] in DETERMINERS
                or (
                    _content_word(toks[i + 2])
                    and toks[i + 2] not in PREPOSITIONS
                    and toks[i + 2] not in CONJUNCTIONS
                    and toks[i + 2] not in ("ahead", "above", "overhead")
                )
            )
        ):
            out.append("lighting")
            i += 2
            continue
        # "back" directly after a verb form is a directional particle
        # ("held BACK by its owner", "a dog brings BACK a ball") and
        # carries no scene content. Followed by "of" (or after a
        # determiner, which the verbish guard already excludes) it is the
        # body/region noun ("into the BACK OF a truck") — blind-9 finding
        if w == "back" and out and _is_verbish(out[-1]) and nxt != "of":
            i += 1
            continue
        # ... and "back" between a verb's OBJECT and a goal preposition is
        # the same particle ("bringing a ball BACK to its owner",
        # "throwing it BACK into the water"). A determiner right before
        # keeps the body-part/region noun ("with its BACK to the camera");
        # goal preps only, so "the back of a truck" / "a chair in the
        # back" stay nouns — verify-drive finding (round-3 session-9)
        if (
            w == "back"
            and out
            and out[-1] not in DETERMINERS
            and nxt in ("to", "toward", "towards", "into", "onto")
        ):
            i += 1
            continue
        # floating quantifiers before a VP distribute over the subject and
        # carry no scene content ("two men EACH holding a racket", "BOTH
        # wearing suits"): drop, like the determiner-quantifier drop.
        # Before a noun they stay determiners ("EACH person") — blind-7
        if w in ("each", "both") and nxt is not None and _is_verbish(nxt):
            i += 1
            continue
        # "overhead" is an adverb when bare ("seagulls flying OVERHEAD")
        # but an attribute before a noun ("the OVERHEAD compartment") —
        # blind-8 finding + fix
        if w == "overhead" and not (nxt is not None and _nounish(nxt)):
            i += 1
            continue
        # "ahead" is always an adverb — it never premodifies a noun ("a
        # row of traffic lights up AHEAD", "the road AHEAD") and carries
        # no scene content — adversarial-test finding (it had become
        # an NP head: (ahead, light))
        if w == "ahead":
            i += 1
            continue
        # anaphoric prep phrases restate structure already in the graph
        # ("a bathroom with a toilet and a sink IN IT" — the sink is in
        # the bathroom): drop prep+pronoun so the dangling prep cannot
        # cancel a pending object distribution. Guard: "her"/"him" double
        # as possessive determiners, so the drop needs the pronoun to END
        # the phrase ("on her HEAD" keeps its locative)
        if w in PREPOSITIONS and nxt in _ANAPHORS and (
            nxt2 is None or not _nounish(nxt2)
        ):
            i += 2
            continue
        # reciprocal objects of ANY preposition drop with it, like the
        # "next to each other" idiom ("playing chess AGAINST ONE
        # ANOTHER", "seated across FROM ONE ANOTHER", "leaning against
        # one another ON A SHELF" keeps its re-anchored locative) —
        # blind-11 finding
        if w in PREPOSITIONS and (nxt, nxt2) in (
            ("one", "another"), ("each", "other")
        ):
            i += 3
            continue
        # one/the-other anaphora over a plural head have SET semantics:
        # both halves predicate the plural NP ("two dogs on a bed ONE
        # sleeping and THE OTHER playing" -> the dogs sleep and play).
        # "one" before a gerund rewrites to a VP coordination; "the
        # other" before a gerund drops so its VP re-anchors the same
        # way. A determiner/preposition before "one" keeps the head
        # reading ("the ONE holding a balloon", "on one") — blind-11
        if (
            w == "one"
            and nxt is not None
            and nxt.endswith("ing")
            and _is_verbish(nxt)
            and (not out or out[-1] not in DETERMINERS)
            and (not out or out[-1] not in PREPOSITIONS)
            # a NOUN after the gerund means "one" is a count determiner
            # ("holding ONE SLEEPING BABY"), not the anaphor — the
            # anaphoric VP ends in a conjunction/prep/stream end
            # ("one sleeping AND the other...") — guard
            and not (nxt2 is not None and _nounish(nxt2))
        ):
            out.append("and")
            i += 1
            continue
        if (
            w == "the"
            and nxt == "other"
            and nxt2 is not None
            and nxt2.endswith("ing")
            and _is_verbish(nxt2)
            # same guard: "the OTHER RUNNING DOG" is a determined NP
            # with a gerund attribute, not the anaphor — guard
            and not (
                i + 3 < len(toks) and _nounish(toks[i + 3])
            )
        ):
            i += 2
            continue
        # asyndetic lists: PTB strips the commas from "a stove, a sink
        # and a refrigerator", leaving determiner-to-determiner junctures
        # that would otherwise read as appositives. A juncture whose
        # lookahead reaches a conjunction BEFORE any verb/prep/copula is
        # a list item — rewrite it as explicit coordination. True
        # appositives ("a man a tourist TAKING a photo") hit the verb
        # first and stay appositive.
        if out and _nounish(out[-1]) and (
            w in _LIST_DETS
            # bare-plural lists ("a bowl of ORANGES APPLES and bananas"):
            # a plural-to-plural juncture whose lookahead reaches a
            # conjunction is a comma-stripped list too. Noun-noun
            # compounds ("city bus") have a singular first noun, so the
            # double-plural requirement keeps them intact; s-final
            # ATTRIBUTIVE nouns ("TENNIS shoes", "SPORTS cars") are
            # compounds, not list items, and are excluded by lexicon.
            or (
                w.endswith("s")
                and _nounish(w)
                and out[-1].endswith("s")
                and out[-1] not in _S_ATTRIBUTIVE
            )
            # singular fixture/appliance junctures never compound
            # ("a TOILET SINK and bathtub" is a stripped-comma list)
            or (
                w in _LIST_NOUNS
                and out[-1] in _LIST_NOUNS
                and w != out[-1]
            )
        ):
            j = i + 1
            while j < len(toks) and not (
                toks[j] in CONJUNCTIONS
                or toks[j] in PREPOSITIONS
                or toks[j] in COPULAS
                or toks[j] in SUBORDINATORS
                or _is_verbish(toks[j])
            ):
                j += 1
            if j < len(toks) and toks[j] in ("and", "or"):
                out.append("and")
        out.append(w)
        i += 1
    toks = out

    tuples: Set[Tuple3] = set()
    nps: List[_NP] = []
    pending_rel: str | None = None  # relation awaiting its object NP
    rel_subj: _NP | None = None
    cur: List[str] = []
    last_np: _NP | None = None
    # (subject NP, object NP) of the last completed LOCATIVE prep relation
    # ("of" excluded: partitives/possessives keep their own head) — a
    # following copula predicates the SUBJECT ("the man on the left IS
    # smiling" -> (man, smile), not (left, smile))
    last_loc_rel = None
    # the preposition that built last_loc_rel: "with" accompaniment flips
    # the gerund re-anchor below when its object is animate ("a bench
    # WITH A MAN sleeping" -> the man sleeps, not the bench)
    last_loc_prep: "str | None" = None
    after_conj = False  # the segment after an NP-coordination close forms
    # its own NP even without a determiner ("dogs and CATS SITTING ...")
    # set alongside after_conj by the SUBORDINATE boundary only ("while",
    # finite-"as"): the segment opens a clause, so the object-position
    # noun reading for _S_NOUN_OBJECT_ONLY must NOT apply ("as smoke
    # RISES" is a clause, "food and DRINKS" is a list) — blind-9 finding
    after_subord = False
    # a relativizer immediately before a copula binds the copula to the
    # NP just closed ("a mat THAT is torn" -> (mat, torn)), overriding the
    # locative re-anchor below
    rel_before_copula = False
    # the NP a relativizer bound a clause to: it is now a clause SUBJECT,
    # so the motion-prep agent re-anchor must not treat it as the outer
    # verb's object ("a man riding a horse THAT IS JUMPING over a fence"
    # -> the horse goes over the fence, not the man) — blind-10 finding
    rel_clause_np: "_NP | None" = None
    # "not"/"n't" before a verb/preposition negates the VP: the verb and
    # its immediately-following relation are suppressed, the NPs survive
    # as objects ("a cat NOT sitting on the mat" -> cat, mat, no
    # (cat, sit)/(cat, on, mat)). Scope: negate_vp covers the verb itself,
    # negate_rel the prep right after it; BOTH clear at the next clause
    # boundary (determiner/copula/conjunction) so later verbs are
    # unaffected ("a man not wearing a hat IS HOLDING A DOG" keeps
    # (man, hold, dog)).
    negate_vp = False
    negate_rel = False
    # exemplification tail ("foods INCLUDING pizza and salad"): NPs close
    # as bare entities — no relation to the listing head, no distribution
    # of its pending relation — until the next copula/clause boundary
    exemplar_mode = False
    negated_verb: "str | None" = None  # the dropped verb form: passive
    # participles let a PLACE locative survive negation (blind-9)
    # NPs that closed as the object of a negated VP: excluded from
    # subject-coordination ("a cat not sitting on a MAT and a dog eating
    # food" must not mirror the dog's relations onto the mat)
    negated_np_ids: Set[int] = set()
    detached = False  # next det-less segment closes as its own NP
    # subject of the negated VP: later verbs re-anchor past the stranded
    # object to it ("a man not wearing a hat IS HOLDING a dog" -> man holds)
    negated_subject: "_NP | None" = None
    # (subj NP, rel word, obj NP) of the last completed ACTIVE relation —
    # the anchor for coordination: "a man holding a drink AND wearing a
    # hat" re-anchors the post-conj verb to the subject; "wearing a dress
    # AND a hat" distributes the relation over the coordinated object
    last_rel3: tuple | None = None
    last_rel3_slot = "obj"
    # coordinated-object candidates deferred to end of stream: (subj NP,
    # rel word, obj NP). Cancelled if the object later starts its own
    # relation ("...and a woman ON a chair" is a new clause, not a
    # distributed object).
    dist_pending: List[tuple] = []
    # NP -> coordinated-partner NPs: "DOGS AND CATS sitting on a couch" —
    # relations/verb attributes whose subject is `cats` mirror onto `dogs`
    coord_partner: Dict[int, List["_NP"]] = {}
    # possessed with-object -> its owner ("a woman WITH HER HAIR in a
    # ponytail ..."): later verbs/locatives that land on the part via the
    # chain walk hop back to the owner even after last_rel3 has moved on
    # (fix: the blind-8 body-part guard had left clause
    # subjecthood on the part)
    poss_owner: Dict[int, "_NP"] = {}
    # the NP closed at the last conjunction with no relation of its own —
    # the candidate left-hand side of a subject coordination
    conj_prev: "_NP" | None = None
    # a ditransitive verb relation whose object is an ANIMATE recipient,
    # captured at a det-to-det juncture ("handing A WOMAN | A slice"):
    # the NEXT NP is the true theme — the relation re-targets to it and
    # the recipient stays a bare entity; an EVENT-noun theme rewrites the
    # whole frame to its light-verb reading ("giving her mother A HUG" ->
    # (girl, hug, mother)) — blind-11 finding
    ditrans_prev: "tuple | None" = None
    # (subj NP, obj NP) of the last completed "of" relation: a locative
    # after the object re-anchors to a CONTAINER subject ("a plate of food
    # ON a table" -> the plate is on the table)
    last_of_rel = None
    # the VERB relation whose object the of-subject was, captured before
    # last_rel3 is overwritten by the of-relation itself ("pushing a CART
    # full of luggage ..." keeps (man, push, cart) reachable so a motion
    # prep after the of-object re-anchors to the man)
    last_of_owner = None
    # the most recent 3-tuple whose relation is a VERB (prep relations
    # overwrite last_rel3, but chain re-anchors need the verb's agent:
    # "a couple WALKING their dog on a leash in the park")
    last_verb_rel3 = None

    def capture_of_owner():
        if (
            last_rel3 is not None
            and isinstance(last_rel3[1], str)
            and _is_verbish(last_rel3[1])
        ):
            return last_rel3
        return None

    def aggregate_of_passthrough(head_np: "_NP", content_np: "_NP") -> None:
        """Aggregate head (string/strand): the locative that targeted the
        aggregate passes through to its of-object ("dancing UNDER a STRING
        of LIGHTS" -> the couple is under the lights); the partitive
        (string, of, lights) still holds. Called from EVERY of-completion
        site so the rewrite doesn't depend on what follows the phrase
        (fix). Deliberately does NOT re-point last_loc_rel: a
        trailing gerund belongs to the of-content ("a string of lights
        HANGING from a tree" — the lights hang), not to the locative
        chain's subject (fix)."""
        if not (
            head_np.head in AGGREGATE_OF_NOUNS
            and last_loc_rel is not None
            and head_np is last_loc_rel[1]
            and last_loc_rel[0] is not head_np
        ):
            return
        loc_subj = last_loc_rel[0]
        old = (
            _norm(loc_subj.head),
            _norm(last_loc_prep),
            _norm(head_np.head),
        )
        tuples.discard(old)
        for p in coord_partner.get(id(loc_subj), []):
            tuples.discard((_norm(p.head),) + old[1:])
        add_subj_tuple(loc_subj, _norm(last_loc_prep), _norm(content_np.head))
    # APPOSITIVE pair: the NP that closed immediately before the currently
    # open determiner-NP with NO connective between them ("a man , a
    # tourist , taking a photo" arrives determiner-to-determiner once
    # punctuation strips) — the appositive restates the first NP, so verb
    # agency passes back to it. Cleared by every connective (prep, copula,
    # conjunction, possessive), so list-like NPs joined by "and" never hit
    # this path.
    appos_prev: "_NP | None" = None
    # Sentence-INITIAL verb-led segment with no subject yet ("SKIING DOWN
    # THE MOUNTAIN is a man in red"): the verbs and their locative are
    # stashed, and an inverted copula later binds them to the post-copula
    # NP ((man, ski), (man, down, mountain)).
    orphan_verbs: List[str] = []
    orphan_pending: "str | None" = None
    orphan_rel: "tuple | None" = None
    invert_pending = False

    def add_subj_tuple(subj_np: "_NP", *rest: str) -> None:
        """Emit a tuple for subj_np and mirror it onto coordinated
        partners ("dogs and cats SITTING" -> both sit). "of" relations
        never mirror: the partitive/possessive binds to its own head
        only ("a laptop and a cup OF COFFEE" — the laptop is not of
        coffee; the shared locative still mirrors)."""
        tuples.add((_norm(subj_np.head),) + rest)
        if len(rest) == 2 and rest[0] == "of":
            return
        for p in coord_partner.get(id(subj_np), []):
            tuples.add((_norm(p.head),) + rest)

    def invert_emit(subj: "_NP") -> None:
        """Bind the stashed sentence-initial VP to its inverted-copula
        subject: the first NP to close after the copula."""
        nonlocal invert_pending, orphan_rel
        for v in orphan_verbs:
            if _attr_ok(v):
                add_subj_tuple(subj, _norm(PARTICIPLE_BASE.get(v, v)))
        if orphan_rel is not None:
            add_subj_tuple(
                subj, _norm(orphan_rel[0]), _norm(orphan_rel[1].head)
            )
        orphan_verbs.clear()
        orphan_rel = None
        invert_pending = False

    def _attr_ok(v: str) -> bool:
        return (
            v not in FRAMING_PARTICIPLES and v not in ASPECTUAL_VERBS
        )

    def at_rel3_anchor() -> "_NP | None":
        """The NP that coordination re-anchors FROM: the object of the
        last active relation, or — for a passive — its agent. None when no
        relation has completed."""
        if last_rel3 is None:
            return None
        return last_rel3[2] if last_rel3_slot == "obj" else last_rel3[0]

    def clause_subject(np_: "_NP | None") -> "_NP | None":
        """The stranded object of a negated VP passes clause-subject duty
        back to the VP's subject."""
        if (
            np_ is not None
            and id(np_) in negated_np_ids
            and negated_subject is not None
        ):
            return negated_subject
        return np_

    def agent_subject(np_: "_NP") -> "_NP":
        """Non-agent heads (clothing/body parts) pass verb agency to the
        possessor/wearer: 'a man with a BEARD holding a phone' -> man
        holds; 'a child wearing a HELMET rides a bicycle' -> the child
        rides (the helmet is the object of the last active relation)."""
        if np_ is rel_clause_np:
            # a relativizer bound this NP as its own clause subject: the
            # embedded VP is predicated OF the part ("a woman whose HAIR
            # is BLOWING in the wind" -> the hair blows, not the woman)
            # — blind-13 finding
            return np_
        if np_.head in NON_AGENT or (
            np_.head in BODY_PART_NOUNS and np_.poss
        ):
            if last_loc_rel is not None and np_ is last_loc_rel[1]:
                return last_loc_rel[0]
            if (
                last_rel3 is not None
                and np_ is last_rel3[2]
                and last_rel3_slot == "obj"
            ):
                return last_rel3[0]
            if last_verb_rel3 is not None and np_ is last_verb_rel3[2]:
                # the verb relation that introduced this wearable was
                # superseded by a later non-verb relation ("wearing a
                # BACKPACK filled with books WALKING through a library"
                # — last_rel3 is now the with-locative, but the wearer
                # still walks) — blind-6 finding
                return last_verb_rel3[0]
            owner = poss_owner.get(id(np_))
            if owner is not None:
                # possessed with-part whose relation has been superseded
                # ("a woman with HER HAIR in a ponytail COOKING in a
                # kitchen" — the woman cooks, even though last_rel3 is
                # now the hair's ponytail locative) — fix
                return owner
        return np_

    def stative_with_reanchor(np_: "_NP", v: str) -> "_NP | None":
        """A participle after a stative-cover's WITH-object describes the
        COVERED subject ("a pizza topped with mushrooms CUT into eight
        slices" -> the pizza is cut), consistent with the covering
        locative re-anchor that routes the following into-PP to the same
        subject — blind-7 finding. Returns the covered subject, or None
        when the rule doesn't apply (shared by close_np's trailing-verb
        loop and attach_lone_segment)."""
        if (
            not v.endswith("ing")
            and _is_participle(v)
            and last_rel3 is not None
            and np_ is last_rel3[2]
            and last_rel3[1] == "with"
            and any(
                (_norm(last_rel3[0].head), sp) in tuples
                for sp in _STATIVE_NORMED
            )
        ):
            return last_rel3[0]
        return None

    def gerund_agent(np_: "_NP", verb: str) -> "_NP":
        """Verbs act on the locative-relation SUBJECT when their nearest
        NP is a locative object — always for -ing forms ("a dog ON THE
        BEACH chasing a ball" -> the dog chases; "a man on a bench
        reading" -> the man reads), and for finite forms when the nearest
        NP is a PLACE noun, which cannot be a verb agent ("men IN A PARK
        play frisbee" -> the men play). Stative participles keep
        nearest-NP attachment ("a tree COVERED in snow"). Exception: an
        ANIMATE object of "with" keeps the verb itself ("a bench with a
        MAN sleeping" -> the man sleeps; "a train station with PEOPLE
        waiting" -> the people wait) — the accompaniment object is the
        nearest plausible agent, matching dependency-parse attachment."""
        if verb in _STATIVE_COVER:
            # stative coverings describe their OWN NP and never hop past a
            # NON_AGENT head to the clause agent: "a man wearing a backpack
            # FILLED with books" -> the backpack is filled (the agent hop
            # below exists for active verbs: "a child wearing a helmet
            # RIDES a bicycle") — blind-6 finding
            return np_
        if (
            last_loc_rel is not None
            and np_ is last_loc_rel[1]
            and not (
                last_loc_prep == "with"
                and (np_.head in ANIMATE_NOUNS or verb in _EVENT_ING)
            )
            and (
                verb.endswith("ing")
                # places and worn/held equipment cannot be verb agents
                # ("a person ON SKIS makes a jump" -> the person makes)
                or (
                    (np_.head in PLACE_NOUNS or np_.head in NON_AGENT)
                    and not _is_participle(verb)
                )
            )
        ):
            return agent_subject(last_loc_rel[0])
        if (
            last_of_rel is not None
            and np_ is last_of_rel[1]
            and (
                verb.endswith("ing")
                # finite forms too: "a plate of pasta SITS atop a
                # table" -> the plate sits — blind-9 finding
                or (
                    verb in VERBS
                    and verb.endswith("s")
                    and not _is_participle(verb)
                )
            )
            and (
                _norm(last_of_rel[0].head) in _CONTAINER_NORMED
                # quality-of objects (colors/sizes/shapes) are properties,
                # never located agents: "umbrellas of different COLORS
                # LEANING against a fence" -> the umbrellas lean — blind-9
                or np_.head in QUALITY_OF_NOUNS
            )
        ):
            # partitive container: "a CUP of coffee SITTING next to a
            # laptop" -> the cup sits (the container is the located
            # thing, matching the container locative rule above);
            # group/photo heads keep the of-object's agency
            return agent_subject(last_of_rel[0])
        if (
            last_rel3 is not None
            and np_ is last_rel3[2]
            and last_rel3_slot == "obj"
            and isinstance(last_rel3[1], str)
            and _is_verbish(last_rel3[1])
            and np_.head not in ANIMATE_NOUNS
            and (
                verb in _AGENT_ING
                # a FINITE -s verb after a relative/reduced clause's
                # inanimate object is the MATRIX verb and belongs to the
                # clause subject ("a player who hit a ball RUNS to first
                # base" -> the player runs) — blind-9 finding
                or (
                    verb in VERBS
                    and verb.endswith("s")
                    and not _is_participle(verb)
                )
            )
        ):
            # animate-agent gerund after an active verb's INANIMATE
            # object: "riding a motorcycle WEARING a helmet" -> the man
            # wears it (a motorcycle cannot); an animate object keeps
            # nearest attachment ("chasing a cat WEARING a collar")
            return agent_subject(last_rel3[0])
        return agent_subject(np_)

    def place_rel_subject(subj: "_NP", prep, obj_np: "_NP") -> "_NP":
        """A locative whose object is a PLACE noun attaches to the clause
        subject when the pending subject is itself the object of an active
        VERB relation ("two men playing frisbee IN A PARK" -> the men are
        in the park, not the frisbee). Non-place objects keep nearest
        attachment ("wearing a hat ON HER HEAD" -> the hat is on the
        head)."""
        if (
            isinstance(prep, str)
            and prep in PREPOSITIONS
            and prep != "of"
            and obj_np.head in PLACE_NOUNS
            and last_rel3 is not None
            and subj is last_rel3[2]
            and last_rel3_slot == "obj"
            and _is_verbish(last_rel3[1])
            # PROJECTED objects (shadow/light/reflection) exist only at
            # their location, so they keep the locative ("casting a
            # shadow ON THE GRASS" -> the shadow is on the grass, not the
            # tree). Portable objects follow the pinned VP-adjunct
            # convention ("throws a ball IN THE YARD" -> the boy is in
            # the yard) — blind-7 finding
            and subj.head not in _PROJECTED_NOUNS
            # goal verbs (reach/grab): the object's location IS the scene
            # content ("reach a cookie ON THE COUNTER" keeps the cookie
            # there) — blind-7 finding
            and _norm(
                PARTICIPLE_BASE.get(last_rel3[1], last_rel3[1])
            ) not in _GOAL_NORMED
            # a SPANNING structure holds its "over": "crossing a bridge
            # OVER a river" -> the bridge spans the river (NP-modifier
            # attachment), never the crossing agent's path — blind-10
            and not (
                prep == "over" and _norm(subj.head) in _SPANNING_NORMED
            )
            # a relativizer made this object its own clause subject, so
            # the PP stays inside the relative clause ("a man riding a
            # horse THAT IS JUMPING over a fence" -> the horse goes over
            # the fence) — blind-10 finding
            and subj is not rel_clause_np
            # NOTE an animate verb object stays on the agent-attachment
            # path too ("feeding pigeons IN A CITY PARK" -> the man is
            # in the park): VP-adjunct locatives situate the clause
            # SUBJECT under dependency-parse attachment, the convention
            # golden + blind-4 pin ("walks her dog in the park",
            # "feeding pigeons in a city square"). Blind-6's original
            # pigeons-in-park label contradicted those two pins and was
            # aligned to them (see the corpus _comment).
        ):
            cand = last_rel3[0]
            if (
                last_of_rel is not None
                and cand is last_of_rel[1]
                and last_of_rel[0].head in _DEPICTION_NOUNS
            ):
                # the clause subject is the DEPICTED content of a
                # statue/sculpture: the physical object holds the
                # locative ("a STATUE of a man riding a horse IN A CITY
                # SQUARE" -> the statue is in the square; the man still
                # rides the horse) — blind-8 finding
                return last_of_rel[0]
            return cand
        # a POSSESSED body part goes where its owner goes: a locative
        # after the verb's body-part object re-anchors to the agent
        # ("brushing HIS TEETH in front of a mirror" -> the boy is at
        # the mirror). Body-part locative OBJECTS keep nearest
        # attachment ("wearing a hat ON HER HEAD"). — blind-6 finding
        if (
            isinstance(prep, str)
            and prep in PREPOSITIONS
            and prep != "of"
            and subj.head in BODY_PART_NOUNS
            and subj.poss
            and obj_np.head not in BODY_PART_NOUNS
            and last_rel3 is not None
            and subj is last_rel3[2]
            and last_rel3_slot == "obj"
            and _is_verbish(last_rel3[1])
        ):
            return last_rel3[0]
        # determined hand-tool "with"-object after an animate agent's
        # inanimate verb object: an INSTRUMENT of the agent ("cutting a
        # birthday cake WITH A PLASTIC KNIFE" -> the woman holds the
        # knife), matching the pinned cutting-into convention; bare-
        # a PROJECTED of-head (reflection/shadow/light) is the located
        # thing, not its of-content: "a REFLECTION of a building ... IN
        # THE WATER" -> the reflection is in the water (the building is
        # not) — the of-phrase twin of the projected verb-object rule
        # above. — blind-9 finding
        if (
            isinstance(prep, str)
            and prep in PREPOSITIONS
            and prep != "of"
            and last_of_rel is not None
            and subj is last_of_rel[1]
            and last_of_rel[0].head in _PROJECTED_NOUNS
        ):
            return last_of_rel[0]
        # a POSSESSED body-part object of a motion prep keeps nearest
        # attachment: the agent cannot be located relative to their own
        # body part ("holding an umbrella OVER HIS HEAD" — the umbrella
        # is over the head; the motion-prep agent re-anchor had said the
        # man is over his own head) — blind-12 finding
        if (
            isinstance(prep, str)
            and prep in MOTION_PREPS
            and obj_np.head in BODY_PART_NOUNS
            and obj_np.poss
            and last_verb_rel3 is not None
            and subj is last_verb_rel3[0]
        ):
            return last_verb_rel3[2]
        # a PLACE locative after a by-passive with an INANIMATE agent
        # anchors to the SURFACE subject (the patient): "a man getting
        # hit by a wave AT THE BEACH" -> the man is at the beach — a
        # natural force has no location of its own in the scene. An
        # ANIMATE by-agent keeps nearest attachment ("a frisbee thrown
        # by its OWNER in a park" -> the owner is in the park, blind-6
        # pin), as do non-place objects ("a sandwich made by a chef IN
        # A WHITE APRON") — blind-11 finding
        if (
            isinstance(prep, str)
            and prep in PREPOSITIONS
            and prep != "of"
            and obj_np.head in PLACE_NOUNS
            and last_rel3 is not None
            and last_rel3_slot == "subj"
            and subj is last_rel3[0]
            and subj.head not in ANIMATE_NOUNS
        ):
            return last_rel3[2]
        # a simile object is not a scene entity and cannot be located: a
        # PLACE locative after "like X" re-anchors to the compared
        # subject ("a train that looks LIKE A DRAGON at a station" ->
        # the train is at the station) — blind-9 finding
        if (
            isinstance(prep, str)
            and prep in PREPOSITIONS
            and prep != "of"
            and obj_np.head in PLACE_NOUNS
            and last_rel3 is not None
            and subj is last_rel3[2]
            and last_rel3_slot == "obj"
            and last_rel3[1] == "like"
        ):
            return last_rel3[0]
        # plural tools stay furnishings ("setting a table with FORKS")
        # and non-tool objects keep nearest attachment ("a bed WITH A
        # STRIPED COMFORTER"). — blind-6 finding
        if (
            prep == "with"
            and obj_np.head in TOOL_NOUNS
            and obj_np.det
            and last_rel3 is not None
            and subj is last_rel3[2]
            and last_rel3_slot == "obj"
            and isinstance(last_rel3[1], str)
            and _is_verbish(last_rel3[1])
            and subj.head not in ANIMATE_NOUNS
            and last_rel3[0].head in ANIMATE_NOUNS
        ):
            return last_rel3[0]
        # ambience/event objects (lighting/weather/depth/occasion)
        # describe the SCENE, not the nearest object: a locative chain
        # re-anchors to the chain's subject ("two cats on a sill IN THE
        # SUN" -> the cats are in the sun; "a trick on his skateboard AT
        # A COMPETITION" -> the man is there). Ordinary place objects
        # keep nearest chaining ("a dog on a bed NEXT TO A PILLOW").
        if (
            isinstance(prep, str)
            and prep in PREPOSITIONS
            and (
                obj_np.head in AMBIENT_NOUNS
                or obj_np.head in EVENT_NOUNS
                # a rideable "on"-object carries the chain's subject
                # ("riding up a hill ON A BIKE" -> the man is on it)
                or (prep == "on" and obj_np.head in RIDEABLE_NOUNS)
            )
            and last_loc_rel is not None
            and subj is last_loc_rel[1]
            # a scene-"with" accompaniment object of an INANIMATE subject
            # is a standalone entity whose own ambience stays local: "a
            # field WITH MOUNTAINS in the background" -> the mountains
            # are in the background, not the field. An animate agent's
            # instrument-with still re-anchors ("cutting a cake with a
            # knife AT A PARTY" -> the woman is at the party) — blind-9
            and not (
                last_loc_prep == "with"
                and last_loc_rel[0].head not in ANIMATE_NOUNS
            )
        ):
            cand = last_loc_rel[0]
            if last_verb_rel3 is not None and cand is last_verb_rel3[2]:
                # the chain's subject is itself a verb's THEME: the
                # scene situates the verb's AGENT ("a pitcher throwing
                # a ball to a batter DURING A BASEBALL GAME" -> the
                # pitcher is at the game, not the ball) — blind-6
                return last_verb_rel3[0]
            return cand
        # from-to path: both endpoints locate the MOVER ("a train
        # traveling FROM a station TO another" — the train goes to the
        # second station; nearest attachment had located the first
        # station at the second) — blind-13 finding
        if (
            prep == "to"
            and last_loc_prep == "from"
            and last_loc_rel is not None
            and (
                subj is last_loc_rel[1]
                # ... including through the endpoint's partitive ("from
                # one side OF THE ROAD to the other" — the road is the
                # from-endpoint's of-object, and the mover still goes to
                # the other side)
                or (
                    last_of_rel is not None
                    and subj is last_of_rel[1]
                    and last_of_rel[0] is last_loc_rel[1]
                )
            )
        ):
            return last_loc_rel[0]
        # result-'into' object of a transformation participle: the
        # following locative belongs to the TRANSFORMED subject ("a
        # sandwich CUT INTO two halves ON A PLATE" -> the sandwich is on
        # the plate; the halves are its form, not a location) — blind-13
        if (
            isinstance(prep, str)
            and prep in PREPOSITIONS
            and prep != "of"
            and last_loc_prep == "into"
            and last_loc_rel is not None
            and subj is last_loc_rel[1]
            and any(
                (_norm(last_loc_rel[0].head), m) in tuples
                for m in _TRANSFORM_NORMED
            )
        ):
            return last_loc_rel[0]
        # a MOUNTED/HUNG subject is the located thing throughout its
        # locative chain: "a mirror MOUNTED on a wall ABOVE A SINK" ->
        # the mirror is above the sink (the attachment surface is not
        # re-located by the chain) — blind-9 finding
        if (
            isinstance(prep, str)
            and prep in PREPOSITIONS
            and prep != "of"
            and last_loc_rel is not None
            and subj is last_loc_rel[1]
            and last_loc_prep in ("on", "to")
            and obj_np.head not in BODY_PART_NOUNS
            and any(
                (_norm(last_loc_rel[0].head), m) in tuples
                for m in _MOUNT_NORMED
            )
        ):
            return last_loc_rel[0]
        return subj

    def cancel_dist(np_: "_NP") -> None:
        """np_ became the subject of its own relation: it was a new clause
        subject, not a distributed object/agent. Filter on the VARIED slot
        (d[3]) — for passive-agent candidates the varied NP sits in the
        subject position, not d[2]."""
        dist_pending[:] = [d for d in dist_pending if d[3] is not np_]

    def content_count(ws: List[str]) -> int:
        return sum(1 for t in ws if _content_word(t))

    def close_np(defer_verbs: bool = False) -> List[str]:
        """Resolve cur: strip trailing gerunds (attributes of the NP head),
        build the NP, and complete any pending relation with it. With
        ``defer_verbs`` the stripped trailing verbs are RETURNED instead of
        emitted as attributes — the 'by'-passive caller turns them into the
        inverted relation's verb."""
        nonlocal cur, last_np, pending_rel, rel_subj, after_conj, \
            last_loc_rel, last_loc_prep, last_rel3, last_rel3_slot, \
            conj_prev, last_of_rel, last_of_owner, last_verb_rel3, \
            detached, appos_prev, after_subord, negated_subject, \
            ditrans_prev
        entry_conj = after_conj
        after_conj = False
        entry_subord = after_subord
        after_subord = False
        entry_detached = detached
        detached = False
        # a ditransitive capture survives exactly ONE segment: the NP
        # closing now is its candidate theme (blind-11)
        entry_ditrans = ditrans_prev
        ditrans_prev = None
        without_possessor: "_NP | None" = None  # blind-11: "without" obj
        get_causative_obj: "_NP | None" = None  # blind-11: get-causative
        words = list(cur)
        cur = []

        trailing_verbs: List[str] = []
        # strip trailing verbs, but never strip the NP's only content word
        # ("a watch" stays a noun; "a dog runs" -> NP dog + verb runs).
        # A segment that is ALL verbs (copula tail "is running") empties out
        # and attaches to the previous NP below.
        # with a relation pending this segment must yield its object NP, so
        # a verb-lexicon noun ("a watch") is never stripped away
        all_verbs = all(
            _is_verbish(t) for t in words if content_count([t])
        )
        if all_verbs and pending_rel in ("on", "off") and words and all(
            t.endswith("ing") and t not in ING_NOUNS
            for t in words
            if content_count([t])
        ) and any(content_count([t]) for t in words):
            # an all-GERUND "object" of on/off is a dangling particle
            # plus the clause VP ("a truck with its lights ON DRIVING
            # down a street"): drop the stray prep, keep the verbs as
            # the VP. Only morphologically marked -ing forms qualify —
            # bare verb-lexicon nouns keep the relation ("falling OFF
            # his BOARD"), and gerund objects of real preps stay NPs
            # ("a brush used FOR painting").
            pending_rel = None
            rel_subj = None
        elif pending_rel is not None:
            all_verbs = False
        if all_verbs and words and (
            # a determiner opens a real NP — the segment cannot be a pure
            # verb run ("A SLICE of pizza", "THE WAVES crash on the
            # shore"); copula tails and verb chains are always det-less
            any(t in DETERMINERS and t not in NUMBERS for t in words)
            # noun reading for a det-less ambiguous word after a
            # conjunction: "food and DRINKS"
            or (entry_conj and words[-1] in S_NOUN_AFTER_CONJ)
        ):
            all_verbs = False

        def compound_noun_tail() -> bool:
            """Compound noun whose tail is a bare verb-lexicon word ("a
            CUTTING BOARD", "a PORCH SWING", "water SKIS"): the noun
            reading wins when everything before it is an -ing
            premodifier/adjective OR an inanimate non-verb premodifier —
            never strip it as a trailing verb. A plausible agent blocks
            it ("a woman sitting DRINKS...", "a man SWINGS...")."""
            if len(words) < 2:
                return False
            pre = [t for t in words[:-1] if content_count([t])]
            if not pre:
                return False
            if words[-1] in ("turn", "turns") and words[-2] in (
                "left", "right", "u"
            ):
                # direction compound: "a LEFT TURN" is an NP with 'turn'
                # as head ('left' had won the head slot as a stripped
                # participle of leave: (cyclist, signal, left) + (left,
                # turn)) — blind-11 finding
                return True
            if all(t in _SPORT_PREMODS for t in pre) and (
                words[-1] in S_NOUN_AFTER_CONJ or words[-1] in _SPORT_TAILS
            ):
                return True  # "a ski lift", "a ski jump", "a surf board"
            if words[-1] not in S_NOUN_AFTER_CONJ:
                return False
            if (
                words[-1] in _S_NOUN_OBJECT_ONLY
                and pending_rel is None
                and (not entry_conj or entry_subord)
            ):
                return False  # subject position: "a boat SAILS ...",
                # clause after a subordinator: "as smoke RISES"
            if words[-2].endswith("ing") and all(
                t.endswith("ing") or t in ADJ_COORD for t in pre
            ):
                return True  # "a cutting board"
            return all(  # "a porch swing", "a pair of water skis"
                not _is_verbish(t) and t not in ANIMATE_NOUNS for t in pre
            )

        def trans_object_noun() -> bool:
            """An S_NOUN tail after a TRANSITIVE verb in the same segment
            is that verb's bare OBJECT ("a man holding DRINKS", "a woman
            carrying two PADDLES"): keep it as a noun so the bare-object
            split below emits (man, hold, drink) — stripping it as a
            trailing verb had left the relation with no object and a
            bogus (man, drink) attribute. Intransitive chains keep the
            verb reading ("a woman standing WAVES at the camera")."""
            if words[-1] not in S_NOUN_AFTER_CONJ:
                return False
            return any(
                t in _TRANS_OBJ and content_count(words[:k]) >= 1
                for k, t in enumerate(words[:-1])
            )

        while words and _is_verbish(words[-1]) and (
            all_verbs or content_count(words[:-1]) >= 1
        ) and not compound_noun_tail() and not trans_object_noun():
            trailing_verbs.insert(0, words.pop())

        # Bare-object verb split: "a woman drinks coffee" / "a giraffe
        # eating leaves" — an internal verb with content on BOTH sides
        # splits the segment into subject NP + relation + object NP. (The
        # determiner branch already splits "...rides A horse"; this covers
        # the determiner-less object, a top-frequency caption construction
        # per the golden-set error catalogue.) The object side must be
        # verb-free so gerund chains ("sitting eating") pick the LAST verb
        # as the relation and keep earlier ones as subject attributes.
        split_k = -1
        for k in range(len(words) - 1, -1, -1):
            if not (
                _is_verbish(words[k])
                and content_count(words[:k]) >= 1
                and content_count(words[k + 1 :]) >= 1
            ):
                continue
            if all(
                not _is_verbish(t)
                # an S_NOUN object of a transitive verb counts as a noun
                # on the right side ("holding DRINKS", "carrying two
                # PADDLES") — the strip above kept it for exactly this
                # split. Verify-drive finding (round-3 session-9).
                or (t in S_NOUN_AFTER_CONJ and words[k] in _TRANS_OBJ)
                for t in words[k + 1 :]
            ):
                # clean right side — but skip a compound participle
                # INSIDE an object NP ("a man HOLDING two PARKED cars":
                # parked modifies cars, holding is the clause verb), so
                # the search falls through to the true verb — blind-7
                if _object_compound_tail(words, k):
                    continue
                split_k = k
                break
            if _compound_right_side(words, k):
                # the verbish right side is itself one compound NP
                # ("holding TWO PARKED CARS") — blind-7 audit
                split_k = k
                break
        if split_k >= 0:
            obj_content = [
                t for t in words[split_k + 1 :] if content_count([t])
            ]
            if obj_content and all(
                t in COLOR_WORDS or t in PRED_ADJS for t in obj_content
            ):
                # "painted RED AND WHITE" / "curled up ASLEEP": the right
                # side is a color list or predicate adjective —
                # attributes of the subject, not an object NP; the verb
                # joins them as a participle attribute
                trailing_verbs = [words[split_k]] + obj_content + trailing_verbs
                words = words[:split_k]
                split_k = -1
        if split_k >= 0 and (
            words[split_k] in STRICT_PARTICIPLES
            or (
                _licensed_participle(words[split_k])
                and all(
                    # an adjective can never be a clause SUBJECT, so it
                    # licenses the compound too ("an OLD fashioned clock");
                    # neither can a bare count ("TWO potted plants",
                    # "TWO parked cars" are NPs, not two-does-something
                    # clauses) — blind-7 finding
                    t in COMPOUND_PREMODIFIERS
                    or t in ADJ_COORD
                    or t in NUMBERS
                    for t in words[:split_k]
                    if content_count([t])
                )
            )
        ):
            # compound participle NP ("a HORSE DRAWN carriage", "a HALF
            # EATEN sandwich", "a HAND painted sign"): modifier + past
            # participle + bare head inside ONE determiner phrase —
            # modifiers of the final head, not a subject-verb-object
            # clause. Licensed only by a participle-ONLY form (drawn/
            # eaten/...) or a compound premodifier: ambiguous preterites
            # with a real subject stay clauses ("a woman CARRIED bags" ->
            # (woman, carry, bag), fix). -ing splits stay clauses
            # ("a giraffe eating leaves").
            split_k = -1
        if split_k >= 0:
            subj_words, verb = words[:split_k], words[split_k]
            obj_words = words[split_k + 1 :]
            # possessive have + ATTRIBUTIVE participle: "a man who has
            # TATTOOED arms" / "a pizza has MELTED cheese" — the relation
            # is the have-form and the participle describes the OBJECT
            # ((man, tattoo, arm) had said the man tattoos them; the
            # stripped have-form had left a junk (man, ha) attribute) —
            # adversarial-test refinement of the blind-9 aux drop,
            # split-path twin of the attach_lone_segment handling
            obj_attr_run: List[str] = []
            if (
                subj_words
                and subj_words[-1] in ("has", "have", "had")
                and not verb.endswith("ing")
                and _is_participle(verb)
                and verb not in FINITE_NOT_PARTICIPLE
            ):
                obj_attr_run = [verb]
                verb = subj_words[-1]
                subj_words = subj_words[:-1]
            subj_verbs: List[str] = []
            while (
                subj_words
                and _is_verbish(subj_words[-1])
                and content_count(subj_words[:-1]) >= 1
            ):
                subj_verbs.insert(0, subj_words.pop())
            subj_np, obj_np = _flush_np(subj_words), _flush_np(obj_words)
            if subj_np is not None and obj_np is not None:
                nps.append(subj_np)
                nps.append(obj_np)
                if invert_pending:
                    invert_emit(subj_np)
                if entry_detached:
                    # stranded object of a negated VP: it is not the agent
                    # of the following verb ("a man not wearing a HAT
                    # carrying a bag" -> the man carries)
                    negated_np_ids.add(id(subj_np))
                # det-less NP coordinated onto a prep OBJECT, then a
                # verb+bare-object: "in a blue shirt and SHORTS playing
                # tennis" — the split subject joins the prep relation
                # ((man, in, shorts)) and the verb re-anchors to the
                # clause subject (the det-boundary twin of the
                # coord_prep_obj branch below)
                if (
                    entry_conj
                    and pending_rel is None
                    and last_rel3 is not None
                    and last_rel3_slot == "obj"
                    and last_np is last_rel3[2]
                    and isinstance(last_rel3[1], str)
                    and last_rel3[1] in PREPOSITIONS
                    and subj_np.head in NON_AGENT
                    and not any(
                        t in DETERMINERS and t not in NUMBERS
                        for t in subj_words
                    )
                ):
                    add_subj_tuple(
                        last_rel3[0], _norm(last_rel3[1]), _norm(subj_np.head)
                    )
                    if last_rel3[1] != "of":
                        last_loc_rel = (last_rel3[0], subj_np)
                        last_loc_prep = last_rel3[1]
                    conj_prev = None
                # subject coordination: "a man and A WOMAN HOLDING HANDS"
                # -> the split subject mirrors onto the pre-conj NP
                elif entry_conj and conj_prev is not None:
                    coord_partner[id(subj_np)] = [conj_prev] + \
                        coord_partner.get(id(conj_prev), [])
                    conj_prev = None
                for v in subj_verbs:
                    if _attr_ok(v):
                        add_subj_tuple(subj_np, _norm(v))
                # a pending relation ("a man WITH a dog chasing birds")
                # completes with the SUBJECT of the split — FIRST, so the
                # agent re-anchor below can see the locative it creates
                # ("a woman in a HAT drinking coffee" -> woman drinks)
                if pending_rel is not None and rel_subj is not None:
                    if isinstance(pending_rel, tuple):  # passive
                        pv = PARTICIPLE_BASE.get(pending_rel[1], pending_rel[1])
                        tuples.add(
                            (_norm(subj_np.head), _norm(pv), _norm(rel_subj.head))
                        )
                    elif pending_rel == "without" or pending_rel in _GET_FORMS:
                        # negative possession / get-causative: no relation
                        # tuple; the split subject passes clause duty back
                        # to the possessor/causer ("a man WITHOUT a hat
                        # holding an umbrella" -> the man holds) — blind-11
                        negated_np_ids.add(id(subj_np))
                        negated_subject = rel_subj
                    else:
                        p_subj = place_rel_subject(rel_subj, pending_rel, subj_np)
                        add_subj_tuple(
                            p_subj, _norm(PARTICIPLE_BASE.get(pending_rel, pending_rel)), _norm(subj_np.head)
                        )
                        if pending_rel in PREPOSITIONS and pending_rel != "of":
                            last_loc_rel = (p_subj, subj_np)
                            last_loc_prep = pending_rel
                        if pending_rel == "of":
                            last_of_owner = capture_of_owner()
                            last_of_rel = (p_subj, subj_np)
                            aggregate_of_passthrough(rel_subj, subj_np)
                        if pending_rel == "with" and subj_np.poss:
                            poss_owner[id(subj_np)] = p_subj
                        last_rel3 = (p_subj, pending_rel, subj_np)
                        if _is_verbish(pending_rel):
                            last_verb_rel3 = last_rel3
                        last_rel3_slot = "obj"
                base = PARTICIPLE_BASE.get(verb, verb)
                subj_eff = subj_np
                if appos_prev is not None:
                    # appositive restates the previous NP: agency passes to
                    # the first NP ("a man , a tourist , taking a photo" ->
                    # the MAN takes)
                    subj_eff = appos_prev
                    appos_prev = None
                agent = gerund_agent(clause_subject(subj_eff), verb)
                add_subj_tuple(agent, _norm(base), _norm(obj_np.head))
                for v in obj_attr_run:
                    # the attributive participle of a possessive have
                    # describes the object ("has MELTED cheese")
                    if _attr_ok(v):
                        add_subj_tuple(obj_np, _norm(PARTICIPLE_BASE.get(v, v)))
                last_rel3 = (agent, base, obj_np)
                last_verb_rel3 = last_rel3
                last_rel3_slot = "obj"
                pending_rel = None
                rel_subj = None
                last_np = obj_np
                if defer_verbs:
                    return trailing_verbs
                for v in trailing_verbs:
                    if _attr_ok(v):
                        add_subj_tuple(obj_np, _norm(v))
                return []

        np_ = _flush_np(words)
        if np_ is not None and words and words[0] in (
            "his", "her", "its", "their"
        ):
            np_.poss = True
        if np_ is not None and exemplar_mode:
            # exemplification: a bare entity with its own attributes,
            # outside every relation/coordination path — blind-13
            nps.append(np_)
            conj_prev = None
            if defer_verbs:
                return trailing_verbs
            for v in trailing_verbs:
                if _attr_ok(v):
                    add_subj_tuple(np_, _norm(PARTICIPLE_BASE.get(v, v)))
            return []
        if np_ is None:
            # segment was all verbs/adjectives: attach to the previous NP.
            # After a conjunction the verbs belong to the CLAUSE SUBJECT,
            # not the object just closed: "a man sitting on a bench AND
            # LOOKING at the sky" -> (man, look); last_np moves back to the
            # subject so a following preposition relates it too.
            anchor = last_np
            if (
                entry_conj
                and last_np is not None
                and last_np is at_rel3_anchor()
            ):
                anchor = last_rel3[0]
                last_np = anchor
            elif (
                last_np is not None
                and last_np.poss
                and last_rel3 is not None
                and last_np is last_rel3[2]
                and last_rel3[1] == "with"
            ):
                # possessive-part with-object: the VP belongs to the part's
                # owner ("a truck with ITS LIGHTS on DRIVING down a
                # street" -> the truck drives), and so does the following
                # locative
                anchor = last_rel3[0]
                last_np = anchor
            if anchor is not None and not defer_verbs:
                for v in trailing_verbs:
                    if _attr_ok(v):
                        add_subj_tuple(anchor, _norm(v))
                return []
            return trailing_verbs
        if (
            pending_rel is not None
            and rel_subj is not None
            and not isinstance(pending_rel, tuple)
            and _is_verbish(pending_rel)
            and np_.head in PRED_ADJS
            and all(a in PRED_ADJS or a in COLOR_WORDS for a in np_.attrs)
        ):
            # a predicate adjective "object" of a pending verb relation is
            # an attribute of the SUBJECT, not an entity ("kites can be
            # seen flying HIGH above the beach" -> (kites, fly) + (kites,
            # high)) — the same split the in-segment bare-object path
            # makes; this covers the copula/framing path where the verb
            # chain and the adjective land in different segments — blind-9
            add_subj_tuple(
                rel_subj, _norm(PARTICIPLE_BASE.get(pending_rel, pending_rel))
            )
            for a in [*np_.attrs, np_.head]:
                add_subj_tuple(rel_subj, _norm(a))
            last_np = rel_subj
            pending_rel = None
            rel_subj = None
            return []
        nps.append(np_)
        if invert_pending:
            invert_emit(np_)
        if entry_detached:
            negated_np_ids.add(id(np_))
        if pending_rel is not None and rel_subj is not None:
            if isinstance(pending_rel, tuple):  # ("__passive__", verb)
                verb = pending_rel[1]
                if np_.head in PLACE_NOUNS and verb not in _ENCLOSURE_PARTICIPLES:
                    # a location can't be the agent: "a picture hung BY
                    # THE WINDOW" is locative -> (picture, hang) +
                    # (picture, by, window), not (window, hang, picture).
                    # The attribute uses the PARTICIPLE_BASE form so it
                    # aligns with active phrasings ("a picture HANGING by
                    # the window" stems to the same 'hang')
                    if _attr_ok(verb):
                        add_subj_tuple(
                            rel_subj, _norm(PARTICIPLE_BASE.get(verb, verb))
                        )
                    add_subj_tuple(rel_subj, "by", _norm(np_.head))
                    last_loc_rel = (rel_subj, np_)
                    last_loc_prep = "by"
                    last_rel3 = (rel_subj, "by", np_)
                    last_rel3_slot = "obj"
                else:
                    # "X VERBED by Y" -> (Y, base-verb, X): same tuple the
                    # active phrasing produces, so passive/active captions
                    # align
                    verb = PARTICIPLE_BASE.get(verb, verb)
                    tuples.add(
                        (_norm(np_.head), _norm(verb), _norm(rel_subj.head))
                    )
                    last_rel3 = (np_, verb, rel_subj)
                    last_rel3_slot = "subj"  # coordination varies the agent
            elif pending_rel == "without":
                # negative possession: the absent object is still an
                # entity, the denied relation is not, and clause
                # subjecthood stays with the possessor so the following
                # locative re-anchors ("a pizza WITHOUT any toppings ON
                # A PLATE" -> (pizza, on, plate), no (pizza, without,
                # toppings)) — blind-11 finding
                negated_np_ids.add(id(np_))
                negated_subject = rel_subj
                without_possessor = rel_subj
            elif pending_rel in _GET_FORMS:
                # get-causative: no scene relation ("a child GETTING his
                # face painted"); anchoring state still advances so the
                # trailing locative re-anchors to the causer, and
                # trailing participles describe the OBJECT ((face,
                # painted), not (child, paint)) — blind-11 finding
                last_rel3 = (rel_subj, pending_rel, np_)
                last_verb_rel3 = last_rel3
                last_rel3_slot = "obj"
                get_causative_obj = np_
            else:
                p_subj = place_rel_subject(rel_subj, pending_rel, np_)
                add_subj_tuple(p_subj, _norm(PARTICIPLE_BASE.get(pending_rel, pending_rel)), _norm(np_.head))
                if pending_rel in PREPOSITIONS and pending_rel != "of":
                    last_loc_rel = (p_subj, np_)
                    last_loc_prep = pending_rel
                if pending_rel == "of":
                    last_of_owner = capture_of_owner()
                    last_of_rel = (p_subj, np_)
                    aggregate_of_passthrough(rel_subj, np_)
                if pending_rel == "with" and np_.poss:
                    poss_owner[id(np_)] = p_subj
                last_rel3 = (p_subj, pending_rel, np_)
                if _is_verbish(pending_rel):
                    last_verb_rel3 = last_rel3
                last_rel3_slot = "obj"
        elif (
            entry_conj
            and not entry_detached
            and last_rel3 is not None
            and not trailing_verbs
            and (
                last_np is at_rel3_anchor()
                # chains: "with a stove and a sink AND A REFRIGERATOR" —
                # the NP before this conjunction is itself a deferred
                # distribution candidate, so the relation extends to the
                # next conjunct too
                or (dist_pending and last_np is dist_pending[-1][3])
            )
        ):
            # coordinated object/agent: "wearing a dress AND A HAT" ->
            # (woman, wear, hat). Deferred: cancelled if this NP turns out
            # to start its own clause ("...and a woman ON a chair").
            if (
                last_rel3_slot == "obj"
                and last_rel3[1] == "of"
                and np_.det
                and _norm(last_rel3[0].head) in _CONTAINER_NORMED
            ):
                # a DETERMINED conjunct after a CONTAINER partitive is a
                # parallel object, never an of-conjunct: "a bowl of soup
                # and A SANDWICH on a tray" is two items on the tray, not
                # a (bowl, of, sandwich) — the sandwich coordinates with
                # the CONTAINER so the later locative distributes to both
                # (add_subj_tuple already refuses to mirror of-relations,
                # so "a plate of food and a glass OF WATER" keeps its own
                # partitive). Media/group heads keep the distribution
                # ("a PHOTO of a man and a dog" depicts both) — blind-14
                # finding
                coord_partner[id(np_)] = [last_rel3[0]] + \
                    coord_partner.get(id(last_rel3[0]), [])
            elif last_rel3_slot == "obj":
                dist_pending.append((last_rel3[0], last_rel3[1], np_, np_))
            else:
                dist_pending.append((np_, last_rel3[1], last_rel3[2], np_))
        elif entry_conj and not entry_detached and conj_prev is not None:
            # subject coordination: "DOGS AND CATS sitting on a couch" —
            # later relations/verb attributes on this NP mirror onto the
            # pre-conjunction NP
            coord_partner[id(np_)] = [conj_prev] + \
                coord_partner.get(id(conj_prev), [])
            conj_prev = None
        if (
            entry_ditrans is not None
            and pending_rel is None
            and not entry_conj
            and not entry_detached
        ):
            # double-object resolution (blind-11): the NP that closed at
            # the det juncture was the RECIPIENT; this NP is the theme
            d_subj, d_verb, d_obj1 = entry_ditrans
            d_base = _norm(PARTICIPLE_BASE.get(d_verb, d_verb))
            old = (_norm(d_subj.head), d_base, _norm(d_obj1.head))
            tuples.discard(old)
            for p in coord_partner.get(id(d_subj), []):
                tuples.discard((_norm(p.head),) + old[1:])
            if np_.head in _DITRANS_EVENT:
                # light-verb frame: the event noun IS the relation
                # ("giving her mother a HUG" -> (girl, hug, mother))
                add_subj_tuple(d_subj, _norm(np_.head), _norm(d_obj1.head))
                nps.pop()  # the event noun is not an entity
                last_rel3 = (d_subj, np_.head, d_obj1)
                last_rel3_slot = "obj"
                without_possessor = d_obj1  # last_np falls to the recipient
            else:
                add_subj_tuple(d_subj, d_base, _norm(np_.head))
                last_rel3 = (d_subj, d_verb, np_)
                last_verb_rel3 = last_rel3
                last_rel3_slot = "obj"
        pending_rel = None
        rel_subj = None
        last_np = np_
        if without_possessor is not None:
            # clause subjecthood stays with the possessor/recipient
            last_np = without_possessor
        if defer_verbs:
            return trailing_verbs
        for v in trailing_verbs:
            if _attr_ok(v):
                if (
                    get_causative_obj is not None
                    and not v.endswith("ing")
                    and _is_participle(v)
                ):
                    # the causative's participle describes the OBJECT
                    # ("getting his face PAINTED" -> (face, painted))
                    add_subj_tuple(np_, _norm(PARTICIPLE_BASE.get(v, v)))
                    continue
                if v in COLOR_WORDS:
                    # colors ride into trailing_verbs only via the
                    # participle color-list bundle ("a bench PAINTED
                    # GREEN") — they modify the NP just built, never the
                    # clause subject (fix: "a man sitting on a
                    # bench painted green" re-anchored green to the man
                    # through gerund_agent's place-noun branch)
                    add_subj_tuple(np_, _norm(v))
                    continue
                # "a cat ON A MAT sleeping" -> the cat sleeps (gerund after
                # a locative object re-anchors); participles stay local
                subj_v = gerund_agent(clause_subject(np_), v)
                if subj_v is np_:
                    covered = stative_with_reanchor(np_, v)
                    if covered is not None:
                        subj_v = covered
                add_subj_tuple(subj_v, _norm(v))
                if subj_v is not np_:
                    # clause subjecthood follows the re-anchor so the next
                    # locative relates the subject ("... sleeping IN THE
                    # SUN" -> the cat is in the sun, not the mat)
                    last_np = subj_v
        return []

    def lone_content_segment() -> bool:
        """cur holds content but no real determiner — hangs off the previous
        NP rather than starting a new one."""
        return (
            bool(cur)
            and not after_conj
            and not detached
            and last_np is not None
            and not any(c in DETERMINERS and c not in NUMBERS for c in cur)
        )

    def attach_lone_segment() -> None:
        """cur (det-less) hangs off last_np. A leading verb run followed by
        non-verb content is a bare-object relation ("is drinking water"
        after 'the zebra': (zebra, drink, water), extra leading verbs stay
        attributes); otherwise every content token is an attribute."""
        nonlocal cur, last_rel3, last_rel3_slot, last_np, last_verb_rel3
        words = [c for c in cur if c not in SKIP]
        cur = []
        # verbs anchor to the agent-capable subject ("a man in a HAT
        # drinking coffee" -> man drinks); plain attributes stay with the
        # nearest NP
        anchor = agent_subject(clause_subject(last_np))
        k = 0
        while k < len(words) and _is_verbish(words[k]):
            k += 1
        if 1 <= k < len(words) and (
            not any(_is_verbish(t) for t in words[k:])
            # a compound-participle object NP qualifies too ("smiling and
            # HOLDING two WRAPPED presents" — wrapped modifies presents),
            # mirroring close_np's split loop (fix: the blind-7
            # fix had covered only that path)
            or _compound_right_side(words, k - 1)
        ):
            if all(t in COLOR_WORDS for t in words[k:]):
                # "is painted RED AND WHITE" after an NP: color attributes
                for v in words[:k]:
                    if _attr_ok(v):
                        add_subj_tuple(anchor, _norm(PARTICIPLE_BASE.get(v, v)))
                for c in words[k:]:
                    add_subj_tuple(last_np, _norm(c))
                return
            if all(
                t in COLOR_WORDS or t in PRED_ADJS for t in words[k:]
            ):
                # predicate-adjective "object": subject attributes, not an
                # entity ("kites can be seen flying HIGH above the beach"
                # -> (kites, fly) + (kites, high)) — the lone-segment twin
                # of close_np's split-path intercept — blind-9 finding
                for v in words[:k]:
                    if _attr_ok(v):
                        add_subj_tuple(anchor, _norm(PARTICIPLE_BASE.get(v, v)))
                for c in words[k:]:
                    add_subj_tuple(anchor, _norm(c))
                return
            obj = _flush_np(words[k:])
            if obj is not None:
                nps.append(obj)
                # possessive have + ATTRIBUTIVE participle(s): "a pizza
                # that has MELTED cheese" -> (pizza, have, cheese) +
                # (cheese, melt) — the relation is the have-form and the
                # participles describe the OBJECT, not the VP chain
                # ((pizza, melt, cheese) had said the pizza melts the
                # cheese) — adversarial-test refinement of the blind-9
                # aux drop, which now keeps the have-form in this shape
                if (
                    k >= 2
                    and words[0] in ("has", "have", "had")
                    and all(
                        _is_participle(t) and t not in FINITE_NOT_PARTICIPLE
                        for t in words[1:k]
                    )
                ):
                    rel_word, obj_attr_run = words[0], words[1:k]
                else:
                    rel_word, obj_attr_run = words[k - 1], []
                # the whole verb run is one VP: a gerund head re-anchors it
                # past a locative object to the clause subject ("a man on a
                # bench READING a book" -> the man reads)
                vp_anchor = gerund_agent(
                    clause_subject(last_np), rel_word
                )
                if obj_attr_run:
                    for v in obj_attr_run:
                        if _attr_ok(v):
                            add_subj_tuple(obj, _norm(PARTICIPLE_BASE.get(v, v)))
                else:
                    for v in words[: k - 1]:
                        if _attr_ok(v):
                            add_subj_tuple(vp_anchor, _norm(PARTICIPLE_BASE.get(v, v)))
                base = PARTICIPLE_BASE.get(rel_word, rel_word)
                add_subj_tuple(vp_anchor, _norm(base), _norm(obj.head))
                last_rel3 = (vp_anchor, base, obj)
                last_verb_rel3 = last_rel3
                last_rel3_slot = "obj"
                return
        for c in words:
            if not _attr_ok(c):
                continue
            target = (
                gerund_agent(clause_subject(last_np), c)
                if _is_verbish(c)
                else last_np
            )
            if _is_verbish(c) and target is last_np:
                covered = stative_with_reanchor(last_np, c)
                if covered is not None:
                    target = covered
            add_subj_tuple(target, _norm(c))
            if _is_verbish(c) and target is not last_np:
                # the gerund re-anchored ("a man covered in snow SKIING
                # down a hill"): clause subjecthood follows it, so the
                # next locative relates the man, not the snow
                last_np = target

    for ti, w in enumerate(toks):
        nxt = toks[ti + 1] if ti + 1 < len(toks) else None
        if w == "to" and nxt is not None and _is_verbish(nxt):
            continue  # infinitive marker ("trying TO catch"), not a prep
        if w in ("not", "n't"):
            if nxt is not None and (_is_verbish(nxt) or nxt in PREPOSITIONS):
                negate_vp = True
                negated_verb = None
                # "does n't wear" / "is n't wearing": the auxiliary before
                # the negation carries no scene content either
                if cur and cur[-1] in ("does", "do", "did"):
                    cur.pop()
            continue
        if negate_vp and _is_verbish(w):
            # the negated verb itself: dropped; its immediately-following
            # preposition is suppressed too (negate_rel); a det-less object
            # after it still becomes its own NP (detached)
            if cur:
                close_np()
            negate_vp = False
            negate_rel = True
            detached = True
            negated_subject = last_np
            negated_verb = w
            continue
        if w == "that" and nxt is not None and (
            _is_verbish(nxt) or nxt in COPULAS
        ):
            rel_before_copula = nxt in COPULAS
            if not rel_before_copula:
                # finite relative ("a horse THAT JUMPS over a fence"):
                # the relativized NP is the clause subject of what
                # follows, so its PPs stay inside the relative clause —
                # blind-10 finding (the copula form sets rel_clause_np
                # in the COPULAS branch instead)
                close_np()
                rel_clause_np = last_np
            continue  # relativizer ("a girl THAT holds..."), not a det
        if w in ("which", "who") and nxt is not None and nxt in COPULAS:
            rel_before_copula = True  # "a dog WHICH is sleeping"
            continue
        if w in _EXEMPLAR:
            # exemplification boundary: complete the pending relation on
            # the listing head ("a table WITH various foods INCLUDING
            # pizza..."), then close the examples as bare entities —
            # blind-13 finding
            if cur:
                close_np()
            exemplar_mode = True
            continue
        if w == "'s":
            # possessive clitic: "a man 's hat" -> (man, have, hat); the
            # copular reading ("the dog 's brown") is rare in caption text
            close_np()
            appos_prev = None
            if last_np is not None:
                pending_rel = "have"
                rel_subj = last_np
                cancel_dist(last_np)
            continue
        if w in PREPOSITIONS:
            if (
                # "up" before "to" never reaches this branch: the
                # pre-pass keeps bare "up" only when a determiner/NP
                # follows, so "reaching UP TO grab" drops it there
                w in ("down", "over", "around")
                and nxt == "to"
                and ti + 2 < len(toks)
                and _is_verbish(toks[ti + 2])
            ):
                # directional particle before an infinitive ("bending DOWN
                # to eat grass"): part of the verb, not a locative — the
                # infinitive's object must not become this prep's object
                continue
            if negate_vp or negate_rel:
                # negated relation: close the segment, emit no tuple; the
                # prep's object becomes a standalone NP. EXCEPT a PLACE
                # object of a negated passive PARTICIPLE: there the
                # negation scopes the action, not the location ("a bed
                # that has not been made IN A MESSY BEDROOM" — the bed is
                # still in the bedroom), so the locative survives on the
                # clause subject. Active -ing forms keep the pinned full
                # suppression ("a cat NOT sitting on the mat") — blind-9
                j = ti + 1
                while j < len(toks) and not (
                    toks[j] in PREPOSITIONS
                    or toks[j] in CONJUNCTIONS
                    or toks[j] in COPULAS
                    or toks[j] in SUBORDINATORS
                    or _is_verbish(toks[j])
                ):
                    j += 1
                obj_head = toks[j - 1] if j > ti + 1 else None
                was_passive = (
                    negated_verb is not None
                    and not negated_verb.endswith("ing")
                    and _is_participle(negated_verb)
                    and negated_verb not in FINITE_NOT_PARTICIPLE
                    # placement participles subcategorize the locative:
                    # there the PP is the DENIED argument ("a car not
                    # PARKED in the driveway" — the car is not in the
                    # driveway), so the survival rule must not fire —
                    # adversarial-test refinement of the blind-9 rule
                    and _norm(
                        PARTICIPLE_BASE.get(negated_verb, negated_verb)
                    ) not in _PLACEMENT_NORMED
                )
                negate_vp = False
                negate_rel = False
                if cur:
                    close_np()
                if was_passive and obj_head in PLACE_NOUNS:
                    subj = negated_subject or last_np
                    if subj is not None:
                        pending_rel = w
                        rel_subj = subj
                        continue
                detached = True
                if negated_subject is None:
                    negated_subject = last_np
                continue
            if exemplar_mode:
                # a preposition ENDS the example list: the pending segment
                # closes as its own bare exemplar entity (never as an
                # attribute of the listing head — "books including NOVELS
                # in a library" must not emit (book, novel)). A DETERMINED
                # exemplar keeps the PP by nearest attachment ("including
                # A CAKE with frosting" — the cake carries it, a full NP
                # with its own modifier); bare-plural exemplars pass the
                # PP back to the listing clause exactly as the list-free
                # sentence would attach it ("a table with foods including
                # pizza and salad NEAR A WINDOW" -> (food, near, window))
                # — advisor r3 finding + round-4 refinement
                had_det = any(c in DETERMINERS for c in cur)
                if cur:
                    close_np()
                    if had_det and nps:
                        last_np = nps[-1]
                exemplar_mode = False
            if lone_content_segment() and pending_rel is None:
                # "dogs RUNNING on the beach": gerund/adjective segment ->
                # attributes of the previous NP; the preposition then
                # relates that same NP — EXCEPT a participle before "by",
                # which is a passive ("horse ridden by...")
                if w == "by" and len(cur) == 1 and _is_participle(cur[0]):
                    verb = cur[0]
                    cur = []
                    pending_rel = ("__passive__", verb)
                    rel_subj = last_np
                    continue
                attach_lone_segment()
            else:
                deferred = close_np(defer_verbs=(w == "by"))
                if (
                    w == "by"
                    and deferred
                    and last_np is not None
                    and _is_participle(deferred[-1])
                ):
                    # passive: the deferred participle is the relation verb;
                    # extra stripped verbs (rare) stay attributes
                    for v in deferred[:-1]:
                        tuples.add((_norm(last_np.head), _norm(v)))
                    pending_rel = ("__passive__", deferred[-1])
                    rel_subj = last_np
                    continue
                for v in deferred:  # defer without passive: plain attrs
                    if last_np is not None:
                        tuples.add((_norm(last_np.head), _norm(v)))
                    elif not nps:
                        # sentence-initial verb run with no subject yet:
                        # stash for an inverted copula ("SKIING down the
                        # mountain is a man in red")
                        orphan_verbs.append(v)
            appos_prev = None
            if last_np is not None:
                pending_rel = w
                rel_subj = last_np
                if last_np.head in ANIMATE_NOUNS:
                    # an ANIMATE conjunct taking its own relation is a
                    # parallel clause subject ("...and a WOMAN on a
                    # chair"), so the deferred distribution dies; an
                    # inanimate one holds both roles ("a pizza with
                    # pepperoni and MUSHROOMS on a cutting board" — the
                    # mushrooms are with the pizza AND on the board)
                    cancel_dist(last_np)
                if (
                    w == "with"
                    and last_loc_rel is not None
                    and last_np is last_loc_rel[1]
                    and (
                        last_np.head in PLACE_NOUNS
                        or (
                            last_rel3 is not None
                            and last_np is last_rel3[2]
                            and last_rel3[1] in MOTION_PREPS
                        )
                    )
                    # carried objects are DETERMINED singular NPs ("with
                    # A ball", "with HIS umbrella"); a bare-plural/mass
                    # with-object is a furnishing of the place itself
                    # ("a bed with WHITE SHEETS", "a street with CARS
                    # parked nearby") and keeps nearest attachment
                    # (blind-40 finding)
                    and (
                        nxt in DETERMINERS
                        or nxt in ("his", "her", "its", "their")
                    )
                    # only an ANIMATE chain subject carries things: "a
                    # vase sitting on a table WITH a lace tablecloth"
                    # keeps nearest attachment (the table has the
                    # tablecloth — a vase carries nothing) — blind-7
                    and last_loc_rel[0].head in ANIMATE_NOUNS
                ):
                    # "a dog running on the beach WITH a ball": the dog
                    # has the ball, not the beach; likewise a motion
                    # target never holds the instrument ("cutting into a
                    # cake WITH a knife" -> the woman has the knife)
                    rel_subj = last_loc_rel[0]
                elif (
                    w == "with"
                    and nxt in ("his", "her", "its", "their")
                    and last_rel3 is not None
                    and last_np is last_rel3[2]
                    and isinstance(last_rel3[1], str)
                    and _is_verbish(last_rel3[1])
                    # an ANIMATE object can be the possessor itself
                    # ("photographing a WOMAN with her dog" — the dog is
                    # the woman's): keep nearest attachment there (a
                    # fix); only an inanimate object forces the agent
                    # reading
                    and last_np.head not in ANIMATE_NOUNS
                ):
                    # possessive instrument after an active INANIMATE
                    # object: "spraying water WITH ITS trunk" — the
                    # possessive must refer to the AGENT, so the relation
                    # re-anchors past the object (the water has no trunk)
                    rel_subj = agent_subject(last_rel3[0])
                elif (
                    (w in MOTION_PREPS or w in ("at", "from"))
                    and last_rel3 is not None
                    and isinstance(last_rel3[1], str)
                    # a relativizer made this object its own clause
                    # subject ("a horse THAT IS JUMPING over a fence"
                    # keeps its path) — blind-10 finding
                    and last_np is not rel_clause_np
                    # a spanning structure holds its "over" ("crossing a
                    # bridge OVER a river" -> the bridge spans the river,
                    # NP-modifier attachment) — blind-10 finding
                    and not (
                        w == "over"
                        and last_np is not None
                        and _norm(last_np.head) in _SPANNING_NORMED
                    )
                    and (
                        (
                            last_np is last_rel3[2]
                            and (
                                _is_verbish(last_rel3[1])
                                # chained motion: "falling OFF his board
                                # INTO the ocean", "going DOWN a slope AT
                                # a resort" — the chain's subject keeps
                                # the path
                                or last_rel3[1] in MOTION_PREPS
                            )
                        )
                        # of-chain walk: "pushing a cart full OF LUGGAGE
                        # THROUGH an airport" — the path belongs to the
                        # of-subject's clause, not the of-object
                        or (
                            last_of_rel is not None
                            and last_np is last_of_rel[1]
                            and last_of_owner is not None
                            and last_of_owner[2] is last_of_rel[0]
                        )
                    )
                ):
                    # motion/target/source prep after an active verb's
                    # object: "riding a skateboard DOWN a ramp",
                    # "swinging a bat AT a ball", "drinking water FROM a
                    # pond" — the path/target/source belongs to the AGENT
                    # (the dependency parse attaches the PP to the verb),
                    # not the vehicle/object (blind-40 findings)
                    owner = last_rel3
                    if (
                        last_of_rel is not None
                        and last_np is last_of_rel[1]
                        and last_of_owner is not None
                        and last_of_owner[2] is last_of_rel[0]
                    ):
                        owner = last_of_owner
                    vb = owner[1]
                    if _norm(
                        PARTICIPLE_BASE.get(vb, vb)
                    ) not in _THEME_NORMED:
                        rel_subj = agent_subject(owner[0])
                    # theme-motion verbs keep nearest attachment: the
                    # OBJECT moves ("pouring coffee INTO a mug" -> the
                    # coffee goes in, not the woman)
                elif (
                    w != "of"  # of binds to its head, never re-anchors
                    and last_loc_rel is not None
                    and (
                        last_np is last_loc_rel[1]
                        # a distributed conjunct of the covering counts
                        # too ("a pizza topped with cheese AND MUSHROOMS
                        # on a wooden board" -> the pizza is on the
                        # board) — blind-10 finding
                        or (
                            dist_pending
                            and last_np is dist_pending[-1][3]
                            and dist_pending[-1][0] is last_loc_rel[0]
                        )
                    )
                    and (
                        last_np.head in MATERIAL_NOUNS
                        # a stative-covering participle makes ANY object a
                        # covering ("a refrigerator COVERED in magnets IN
                        # A KITCHEN" -> the refrigerator is in the
                        # kitchen): the subject carries the participle as
                        # an attribute tuple, so membership is checkable
                        or any(
                            (_norm(last_loc_rel[0].head), sp) in tuples
                            for sp in _STATIVE_NORMED
                        )
                    )
                ):
                    # a covering/material is a state, not a location: the
                    # next locative belongs to the covered subject ("a
                    # stop sign covered IN SNOW ON a street corner" ->
                    # the sign is on the corner) — blind-40 finding
                    rel_subj = last_loc_rel[0]
                    # a tethered/leashed object hops one more step to the
                    # verb's agent ("a couple walking their dog ON A
                    # LEASH in the park" -> the couple is in the park)
                    if (
                        last_verb_rel3 is not None
                        and rel_subj is last_verb_rel3[2]
                    ):
                        rel_subj = agent_subject(last_verb_rel3[0])
                elif (
                    last_rel3 is not None
                    and last_np is last_rel3[2]
                    and last_rel3[1] == "with"
                    and last_np.poss
                    # a possessed BODY PART keeps its own locative — the
                    # absolute construction describes the part's
                    # configuration ("a cat with ITS PAWS in the air" ->
                    # the paws are in the air; "with HIS HANDS in his
                    # pockets") — blind-8 finding
                    and last_np.head not in BODY_PART_NOUNS
                ):
                    # possessive-part with-object ("a toilet WITH ITS LID
                    # up IN a small bathroom"): the part belongs to the
                    # subject, so the locative re-anchors past it — the
                    # toilet is in the bathroom, not the lid (blind-40)
                    rel_subj = agent_subject(last_rel3[0])
                elif (
                    last_rel3 is not None
                    and last_np is last_rel3[2]
                    and last_rel3[1] == "for"
                ):
                    # a for-object is a purpose, not a location: a
                    # following locative belongs to the for-subject ("a
                    # passenger waiting FOR A FLIGHT at an airport gate"
                    # -> the passenger is at the gate) — blind-4 finding
                    rel_subj = agent_subject(last_rel3[0])
                elif (
                    w == "for"
                    and last_rel3 is not None
                    and last_np is last_rel3[2]
                    and isinstance(last_rel3[1], str)
                    and _norm(
                        PARTICIPLE_BASE.get(last_rel3[1], last_rel3[1])
                    ) in _BENEFACTIVE_AGENT_NORMED
                ):
                    # benefactive "for" after a NON-TRANSFER action's
                    # object anchors to the AGENT ("a crossing guard
                    # stopping traffic FOR children" -> the guard acts
                    # for the children); transfer/creation verbs keep
                    # nearest attachment ("buying flowers FOR his wife"
                    # -> the flowers are for the wife) — blind-10
                    rel_subj = agent_subject(last_rel3[0])
                elif (
                    w != "of"
                    and last_of_rel is not None
                    and (
                        last_np is last_of_rel[1]
                        # a distributed of-conjunct counts as the of-object
                        # ("a bowl of oranges apples and BANANAS on a
                        # counter" -> the bowl is on the counter)
                        or (
                            dist_pending
                            and last_np is dist_pending[-1][3]
                            and dist_pending[-1][1] == "of"
                            and dist_pending[-1][0] is last_of_rel[0]
                        )
                    )
                    and _norm(last_of_rel[0].head) in _CONTAINER_NORMED
                ):
                    # "a PLATE of food ON a table": the container carries
                    # the locative (photo/group heads keep the of-object)
                    rel_subj = last_of_rel[0]
                elif (
                    w != "of"
                    and last_rel3 is not None
                    and last_np is last_rel3[2]
                    and last_rel3[1] in LIGHT_VERBS
                ):
                    # light-verb object: "DOES a trick ON a skateboard" —
                    # the locative belongs to the agent doing the trick
                    rel_subj = last_rel3[0]
            elif not nps and orphan_pending is None:
                # "skiing DOWN the mountain is ..." awaiting its object —
                # or a sentence-INITIAL preposition opening a locative
                # inversion ("ON the table sits a vase", "NEXT TO the
                # window is a potted plant"): the post-verbal/post-copular
                # NP is the subject the stashed PP binds to — blind-11
                orphan_pending = w
        elif w in COPULAS:
            negate_rel = False
            exemplar_mode = False  # the example list ends at a new clause
            close_np()
            appos_prev = None
            if orphan_pending is not None and last_np is not None:
                if len(nps) == 1:
                    # "skiing down THE MOUNTAIN is ..." / "next to THE
                    # WINDOW is ...": the orphan PP's object is the ONLY
                    # NP so far — bind it; a later copula ("in the
                    # kitchen a woman is cooking") must not capture an
                    # unrelated NP — blind-11 guard
                    orphan_rel = (orphan_pending, last_np)
                orphan_pending = None
            if orphan_verbs or orphan_rel is not None:
                # inverted copula: the next NP to close is the VP's subject
                invert_pending = True
            if (
                not rel_before_copula
                and last_loc_rel is not None
                and last_np is last_loc_rel[1]
            ):
                # copula after a locative object re-anchors to the clause
                # subject: "the man on the left IS smiling" -> (man, smile) —
                # UNLESS a relativizer bound the copula to the object NP
                # ("a cat on a mat THAT is torn" -> (mat, torn))
                last_np = last_loc_rel[0]
            elif not rel_before_copula:
                # likewise past the stranded object of a negated VP ("a man
                # not wearing a hat IS holding a dog" -> man holds)
                last_np = clause_subject(last_np)
            else:
                # the relativizer bound this copula to the object NP ("a
                # dog THAT IS sleeping" sleeps itself): the locative that
                # produced the NP no longer defines clause subjecthood, or
                # the gerund re-anchor would pass the verb back to "man"
                last_loc_rel = None
                last_loc_prep = None
                # only a PROGRESSIVE relative keeps its path PP ("a
                # horse that is JUMPING over a fence" — the horse
                # clears it); a participial predicate closes the
                # clause, so a later PP reverts to the matrix verb ("a
                # bike that is PAINTED red DOWN A STREET" — the man
                # rides down the street) — blind-10 refinement
                if (
                    nxt is not None
                    and nxt.endswith("ing")
                    and _is_verbish(nxt)
                ):
                    rel_clause_np = last_np
            rel_before_copula = False
        elif w in CONJUNCTIONS:
            # attribute coordination stays inside the NP: "black AND white
            # cat" — the next token continues the same bare segment. NP
            # coordination ("a man AND a dog", "sitting and eating") closes.
            if (
                cur
                and nxt is not None
                and nxt not in DETERMINERS
                and nxt not in PREPOSITIONS
                and nxt not in COPULAS
                and not _is_verbish(nxt)
                # only a KNOWN adjective coordinates inside the NP ("black
                # AND white cat"); a noun before "and" is NP coordination
                # ("a bride AND groom" is two objects, "a knife AND fork"
                # likewise) — EXCEPT a det-less predicate segment with no
                # pending relation, which is attributive regardless of
                # lexicon ("the bananas are RIPE and yellow"; "a bowl of
                # RICE and beans" has a pending 'of', so it still closes
                # as an object NP)
                and (
                    cur[-1] in ADJ_COORD
                    or (
                        pending_rel is None
                        and lone_content_segment()
                        and not _is_verbish(cur[-1])
                        # exemplification items are separate entities,
                        # never a shared attribute segment ("including
                        # PIZZA and SALAD") — blind-13
                        and not exemplar_mode
                    )
                )
            ):
                continue
            if (
                pending_rel is None
                and lone_content_segment()
                and any(_content_word(c) for c in cur)
                and all(
                    c in _PRED_ADJ_SET and not _is_verbish(c)
                    for c in cur
                    if _content_word(c)
                )
            ):
                # a pure predicate-adjective segment before NP/PP/VP
                # coordination binds to the clause subject, which keeps
                # the clause ("a kitten is small AND IN THE PALM" -> the
                # kitten is small and in the palm; the adjective had
                # closed as its own NP and captured the locative) —
                # blind-13 finding
                attach_lone_segment()
            negate_vp = False
            negate_rel = False
            close_np()
            appos_prev = None
            pending_rel = None
            rel_subj = None
            after_conj = True
            # a relation-less NP before "and" is a coordination candidate:
            # a later clause on the right-hand NP mirrors onto it — but
            # never the stranded object of a negated VP
            conj_prev = None
            if (
                last_np is not None
                and id(last_np) not in negated_np_ids
                and (
                    last_rel3 is None
                    or (
                        last_np is not last_rel3[2]
                        and last_np is not last_rel3[0]
                    )
                )
            ):
                conj_prev = last_np
        elif w in SUBORDINATORS or (w == "as" and _as_finite_clause(toks, ti)):
            # subordinate VP boundary: the following verbs belong to the
            # clause subject, exactly like a coordinated VP — but with no
            # NP-coordination candidate (while never joins two NPs).
            # "as" qualifies only when it introduces a FINITE clause ("a
            # crowd watches AS a man rides a bull"); role/manner "as"
            # stays skipped ("dressed AS a doctor") — blind-7 finding
            negate_vp = False
            negate_rel = False
            close_np()
            appos_prev = None
            pending_rel = None
            rel_subj = None
            after_conj = True
            after_subord = True
            conj_prev = None
        elif w in DETERMINERS and w not in NUMBERS:
            if cur:
                # content words only: determiners never count, or
                # back-to-back NPs ("a man , a baseball player ," after
                # punctuation stripping) hit the subject-split below and
                # the first NP is silently dropped
                content = [
                    t for t in cur
                    if (t not in DETERMINERS or t in NUMBERS) and t not in SKIP
                ]
                if (
                    content
                    and all(_is_verbish(t) for t in content)
                    and pending_rel is None
                    and (
                        lone_content_segment()
                        or (after_conj and last_np is not None)
                    )
                ):
                    # "...shirt HOLDING an umbrella": verb-only segment —
                    # relation from the previous NP, not a new object. A
                    # verb CHAIN keeps the LAST verb as the relation and
                    # the rest as subject attributes through the framing
                    # filter ("is SEEN riding a horse" -> the man rides,
                    # 'seen' suppressed). After a conjunction the verb
                    # re-anchors to the clause subject ("holding a drink
                    # AND WEARING a hat" -> the man wears, not the drink);
                    # NON_AGENT heads pass agency to their possessor.
                    subj = clause_subject(last_np)
                    if (
                        after_conj
                        and last_np is not None
                        and last_np is at_rel3_anchor()
                    ):
                        subj = last_rel3[0]
                    rel_subj = agent_subject(subj)
                    for v in content[:-1]:
                        if _attr_ok(v) and rel_subj is not None:
                            add_subj_tuple(
                                rel_subj, _norm(PARTICIPLE_BASE.get(v, v))
                            )
                    pending_rel = content[-1]
                    cancel_dist(rel_subj)
                    after_conj = False
                    cur = []
                elif len(content) >= 2 and _is_verbish(cur[-1]):
                    # "a man rides A horse" -> cur == [a, man, rides]:
                    # final word is the verb, the rest the subject NP;
                    # extra trailing verbs on the subject ("a man trying
                    # [to] catch A ball") stay subject attributes
                    verb = cur[-1]
                    subj_words = cur[:-1]
                    cur = []
                    subj_verbs: List[str] = []
                    while (
                        subj_words
                        and _is_verbish(subj_words[-1])
                        and content_count(subj_words[:-1]) >= 1
                    ):
                        subj_verbs.insert(0, subj_words.pop())
                    # perception small clause: an INTERNAL verb with
                    # content on both sides splits the det-less run into
                    # subject + relation + object, and the det-boundary
                    # verb then opens a clause on the OBJECT ("people
                    # WATCHING FIREWORKS lighting THE sky" -> (people,
                    # watch, fireworks) + (fireworks, light, sky)) — the
                    # det-arrival twin of close_np's bare-object split.
                    # Without it the run flushed as one NP headed by the
                    # verb's object. — blind-9 finding
                    small_clause = None
                    for k in range(len(subj_words) - 1, -1, -1):
                        if (
                            _is_verbish(subj_words[k])
                            and content_count(subj_words[:k]) >= 1
                            and content_count(subj_words[k + 1 :]) >= 1
                            and all(
                                not _is_verbish(t)
                                for t in subj_words[k + 1 :]
                            )
                            and not _object_compound_tail(subj_words, k)
                        ):
                            small_clause = (
                                subj_words[k], subj_words[k + 1 :]
                            )
                            subj_words = subj_words[:k]
                            break
                    np_ = _flush_np(subj_words)
                    if np_ is not None:
                        nps.append(np_)
                        if detached:
                            # stranded object of a negated VP ("a man not
                            # holding an UMBRELLA carrying A bag"): not
                            # the agent of the following verb
                            negated_np_ids.add(id(np_))
                            detached = False
                        coord_prep_obj = (
                            after_conj
                            and last_rel3 is not None
                            and last_rel3_slot == "obj"
                            and last_np is last_rel3[2]
                            and isinstance(last_rel3[1], str)
                            and last_rel3[1] in PREPOSITIONS
                            # only NON_AGENT heads (garments/accessories)
                            # join the prep relation: a coordinated
                            # animate/quantified NP ("a man in a hat and
                            # TWO DOGS chasing a ball") is a NEW clause
                            # subject (fix)
                            and np_.head in NON_AGENT
                            and not any(
                                t in DETERMINERS and t not in NUMBERS
                                for t in subj_words
                            )
                        )
                        if coord_prep_obj:
                            # det-less NP coordinated onto a prep OBJECT,
                            # then a gerund: "in a blue shirt and JEANS
                            # riding a bike" — the NP joins the prep
                            # relation ((man, in, jeans)) instead of
                            # becoming the gerund's subject; the clause
                            # subject owns the new locative, so the verb
                            # re-anchor below lands on the man
                            add_subj_tuple(
                                last_rel3[0], _norm(last_rel3[1]), _norm(np_.head)
                            )
                            if last_rel3[1] != "of":
                                last_loc_rel = (last_rel3[0], np_)
                                last_loc_prep = last_rel3[1]
                            conj_prev = None
                        elif after_conj and conj_prev is not None:
                            # "a man and A WOMAN HOLDING an umbrella"
                            coord_partner[id(np_)] = [conj_prev] + \
                                coord_partner.get(id(conj_prev), [])
                            conj_prev = None
                        after_conj = False
                        for v in subj_verbs:
                            if _attr_ok(v):
                                add_subj_tuple(
                                    np_, _norm(PARTICIPLE_BASE.get(v, v))
                                )
                        # an open prep relation completes with this NP
                        # ("a woman IN a red shirt holding an umbrella"):
                        # (woman, in, shirt) must not be dropped, and the
                        # verb's agent re-anchors past NON_AGENT heads
                        if pending_rel is not None and rel_subj is not None \
                                and (
                                    pending_rel == "without"
                                    or pending_rel in _GET_FORMS
                                ):
                            # negative possession / get-causative object
                            # acting as a clause subject: no relation
                            # tuple; clause duty passes back — blind-11
                            negated_np_ids.add(id(np_))
                            negated_subject = rel_subj
                        elif pending_rel is not None and rel_subj is not None \
                                and not isinstance(pending_rel, tuple):
                            p_subj = place_rel_subject(
                                rel_subj, pending_rel, np_
                            )
                            add_subj_tuple(
                                p_subj, _norm(PARTICIPLE_BASE.get(pending_rel, pending_rel)), _norm(np_.head)
                            )
                            if pending_rel in PREPOSITIONS and pending_rel != "of":
                                last_loc_rel = (p_subj, np_)
                                last_loc_prep = pending_rel
                            if pending_rel == "of":
                                last_of_owner = capture_of_owner()
                                last_of_rel = (p_subj, np_)
                                aggregate_of_passthrough(rel_subj, np_)
                            if pending_rel == "with" and np_.poss:
                                poss_owner[id(np_)] = p_subj
                            last_rel3 = (p_subj, pending_rel, np_)
                            if _is_verbish(pending_rel):
                                last_verb_rel3 = last_rel3
                            last_rel3_slot = "obj"
                        if small_clause is not None:
                            sverb, sobj_words = small_clause
                            sobj = _flush_np(sobj_words)
                            if sobj is not None:
                                nps.append(sobj)
                                s_anchor = agent_subject(
                                    clause_subject(np_)
                                )
                                base = PARTICIPLE_BASE.get(sverb, sverb)
                                if _attr_ok(sverb):
                                    add_subj_tuple(
                                        s_anchor, _norm(base),
                                        _norm(sobj.head),
                                    )
                                last_rel3 = (s_anchor, base, sobj)
                                last_verb_rel3 = last_rel3
                                last_rel3_slot = "obj"
                                np_ = sobj
                        last_np = np_
                        pending_rel = verb
                        if appos_prev is not None:
                            # appositive subject: "a man , a tourist ,
                            # TAKING a photo" — agency passes to the first
                            # NP of the adjacent pair
                            rel_subj = agent_subject(
                                clause_subject(appos_prev)
                            )
                            appos_prev = None
                        else:
                            # gerund after a locative object acts on the
                            # clause subject ("a dog ON THE BEACH chasing
                            # A ball" -> the dog chases)
                            rel_subj = gerund_agent(
                                clause_subject(np_), verb
                            )
                        if orphan_pending is not None and len(nps) == 1:
                            # full-verb locative inversion: a sentence-
                            # initial PP, its object NP, then a finite
                            # verb and the TRUE subject ("ON THE TABLE
                            # sits a vase of flowers" -> (vase, sits) +
                            # (vase, on, table), never (table, sit,
                            # vase)) — the stashed PP and the verb both
                            # bind to the first post-verbal NP — blind-11
                            orphan_rel = (orphan_pending, np_)
                            orphan_verbs.append(verb)
                            orphan_pending = None
                            invert_pending = True
                            pending_rel = None
                            rel_subj = None
                else:
                    conj_like = (
                        after_conj or detached or negate_vp or negate_rel
                    )
                    had_connective = pending_rel is not None or conj_like
                    pend_before = pending_rel
                    close_np()
                    # determiner-to-determiner with no connective: the NP
                    # just closed is the left half of an appositive pair
                    appos_prev = (
                        last_np
                        if not had_connective and last_np is not None
                        else None
                    )
                    # ditransitive double object: the verb relation that
                    # just completed onto an ANIMATE recipient, followed
                    # det-to-det by another NP, re-targets to that theme
                    # ("handing A WOMAN | A SLICE of pizza" -> (man,
                    # hand, slice); "giving HER MOTHER | A HUG" -> the
                    # light-verb (girl, hug, mother)). Lists are excluded
                    # by the asyndetic-list rewrite (a conjunction ahead
                    # inserts 'and' and conj_like blocks the capture) —
                    # blind-11 finding
                    if (
                        not conj_like
                        and isinstance(pend_before, str)
                        and pend_before in _DITRANS
                        and last_rel3 is not None
                        and last_rel3_slot == "obj"
                        and last_np is last_rel3[2]
                        and last_rel3[1] == pend_before
                        and last_np.head in ANIMATE_NOUNS
                    ):
                        ditrans_prev = last_rel3
            cur.append(w)
        elif w in SKIP:
            pass
        else:
            cur.append(w)

    # end of stream: a trailing lone segment hangs off the last NP
    # (attributes, or a bare-object relation — attach_lone_segment). After
    # a conjunction, a verb-led det-less segment is a coordinated VP whose
    # subject is the clause subject: "a woman drinking coffee AND EATING
    # CAKE" -> (woman, eat, cake).
    if pending_rel is None and after_conj and cur and last_np is not None:
        tail = [t for t in cur if content_count([t])]
        if (
            tail
            and _is_verbish(tail[0])
            and not all(_is_verbish(t) for t in tail)
        ):
            if last_np is at_rel3_anchor():
                last_np = last_rel3[0]
            after_conj = False
    if lone_content_segment() and pending_rel is None and not exemplar_mode:
        attach_lone_segment()
    close_np()

    # surviving coordinated-object candidates ("wearing a dress and A HAT")
    for subj, rel, obj, _var in dist_pending:
        add_subj_tuple(subj, _norm(rel), _norm(obj.head))

    for np_ in nps:
        tuples.add((_norm(np_.head),))
        for a in np_.attrs:
            tuples.add((_norm(np_.head), _norm(a)))
    return frozenset(tuples)


# --- matching + F-score ------------------------------------------------------


def _elems_match(a: str, b: str) -> bool:
    if a == b:
        return True
    ga = _syn_groups(a, a)
    return bool(ga) and not ga.isdisjoint(_syn_groups(b, b))


def _tuple_match(t1: Tuple3, t2: Tuple3) -> bool:
    return len(t1) == len(t2) and all(_elems_match(a, b) for a, b in zip(t1, t2))


def _max_matching(cl: List[Tuple3], rl: List[Tuple3]) -> int:
    """Maximum bipartite matching size between sorted tuple lists.

    One-to-one assignment via augmenting paths. Greedy iteration over raw
    sets would make the count depend on hash-seed iteration order (synonym
    matches are many-to-many); maximum matching is both order-independent
    and maximal, so a candidate tuple never loses its only partner to one
    that had alternatives.

    Two exact-arithmetic speedups (val-5k profile: the matcher was ~35%
    of SPICE time): (1) exact-equality pairs seed the matching before any
    _tuple_match call — Kuhn's algorithm from ANY initial matching plus
    one augmenting pass per unmatched candidate is still maximum, and on
    real corpora most matches are exact; (2) adjacency rows build lazily,
    only for candidates an augmenting path actually touches."""
    owner = [-1] * len(rl)  # ref index -> matched cand index
    cand_matched = [False] * len(cl)
    rindex: Dict[Tuple3, List[int]] = {}
    for j, r in enumerate(rl):
        rindex.setdefault(r, []).append(j)
    for i, t in enumerate(cl):
        for j in rindex.get(t, ()):
            if owner[j] < 0:
                owner[j] = i
                cand_matched[i] = True
                break

    adj_cache: Dict[int, List[int]] = {}

    def _adj(i: int) -> List[int]:
        a = adj_cache.get(i)
        if a is None:
            t = cl[i]
            a = [j for j, r in enumerate(rl) if _tuple_match(t, r)]
            adj_cache[i] = a
        return a

    def _augment(i: int, seen: List[bool]) -> bool:
        for j in _adj(i):
            if not seen[j]:
                seen[j] = True
                if owner[j] < 0 or _augment(owner[j], seen):
                    owner[j] = i
                    return True
        return False

    total = sum(cand_matched)
    for i in range(len(cl)):
        if not cand_matched[i]:
            total += _augment(i, [False] * len(rl))
    return total


def spice_f(cand: Set[Tuple3], ref: Set[Tuple3]) -> float:
    """SPICE F1 between a candidate tuple set and the union reference set."""
    if not cand or not ref:
        return 0.0
    matched = _max_matching(sorted(cand), sorted(ref))
    p = matched / len(cand)
    r = matched / len(ref)
    return 0.0 if p + r == 0 else 2 * p * r / (p + r)


def _category_filters():
    """The Java scorer's -subset tuple buckets (spice.py:66). Lexicon
    membership is tested in normalized (stemmed) space because tuples carry
    ``_norm``-ed elements ("large" -> "larg")."""
    colors = frozenset(_norm(w) for w in COLOR_WORDS)
    sizes = frozenset(_norm(w) for w in SIZE_WORDS)
    counts = frozenset(_norm(w) for w in NUMBERS)
    return (
        ("All", lambda t: True),
        ("Object", lambda t: len(t) == 1),
        ("Attribute", lambda t: len(t) == 2),
        ("Relation", lambda t: len(t) == 3),
        ("Color", lambda t: len(t) == 2 and t[1] in colors),
        (
            "Cardinality",
            lambda t: len(t) == 2 and (t[1] in counts or t[1].isdigit()),
        ),
        ("Size", lambda t: len(t) == 2 and t[1] in sizes),
    )


_CATEGORY_FILTERS = _category_filters()


def spice_score_set(
    cand: Set[Tuple3], ref: Set[Tuple3]
) -> Dict[str, Dict[str, float]]:
    """Per-category ``{"f", "pr", "re"}`` dicts — the reference wrapper's
    per-image score shape (spice.py:78-91: each image maps category ->
    score tuple, with the jar's JSON ``null`` for undefined categories
    converted to NaN by ``float_convert``)."""
    out: Dict[str, Dict[str, float]] = {}
    nan = float("nan")
    # tuples only match within the same arity (_tuple_match requires equal
    # length), so the bipartite matching decomposes by tuple length: the
    # three arity matchings are computed once and reused for All (their
    # sum — bit-identical to matching the full sets) and for
    # Object/Attribute/Relation (val-5k profile: this halves the number
    # of matchings; only Color/Cardinality/Size still filter+match).
    c_by = {n: sorted(t for t in cand if len(t) == n) for n in (1, 2, 3)}
    r_by = {n: sorted(t for t in ref if len(t) == n) for n in (1, 2, 3)}
    m_by = {
        n: _max_matching(c_by[n], r_by[n]) if c_by[n] and r_by[n] else 0
        for n in (1, 2, 3)
    }
    arity = {"Object": 1, "Attribute": 2, "Relation": 3}
    for name, keep in _CATEGORY_FILTERS:
        if name == "All":
            cn, rn, m = len(cand), len(ref), sum(m_by.values())
        elif name in arity:
            n = arity[name]
            cn, rn, m = len(c_by[n]), len(r_by[n]), m_by[n]
        else:  # lexicon subcategories of the attribute arity
            c = [t for t in c_by[2] if keep(t)]
            r = [t for t in r_by[2] if keep(t)]
            cn, rn = len(c), len(r)
            m = _max_matching(c, r) if c and r else 0
        if cn == 0 and rn == 0:
            # All keeps the flat spice_f convention (0.0, so the corpus
            # mean stays finite even for degenerate empty-graph images);
            # subcategories absent from both sides are NaN (the wrapper's
            # None->NaN float_convert)
            f0 = 0.0 if name == "All" else nan
            out[name] = {"f": f0, "pr": nan, "re": nan}
            continue
        p = m / cn if cn else nan
        rc = m / rn if rn else nan
        # f mirrors spice_f: 0.0 when either side is empty or nothing
        # matched, so the All column stays bit-identical to spice_f and the
        # corpus mean stays finite
        if cn == 0 or rn == 0 or m == 0:
            f = 0.0
        else:
            f = 2 * p * rc / (p + rc)
        out[name] = {"f": f, "pr": p, "re": rc}
    return out


def spice_backend(gts: Dict, res: Dict):
    """``compute_score``-shaped backend: corpus mean of per-image All
    F-scores + per-image subcategory score sets.

    Matches the reference wrapper's exact return shape (spice.py:78-91:
    ``scores[i]`` is a dict category -> {f, pr, re}; the corpus average is
    the mean of ``scores[i]['All']['f']``)."""
    assert sorted(gts.keys()) == sorted(res.keys())
    scores = []
    for img_id in sorted(gts.keys()):
        cand = parse(res[img_id][0])
        ref_union: Set[Tuple3] = set()
        for r in gts[img_id]:
            ref_union |= parse(r)
        scores.append(spice_score_set(cand, ref_union))
    if not scores:
        return 0.0, scores
    return float(np.mean([s["All"]["f"] for s in scores])), scores
