"""Lexicon tables for the SPICE scene-graph parser (FROZEN).

Split out of scene_graph.py in round 4 so the parser freeze
(docs/PARITY.md "The freeze") is diff-enforceable: this module holds
ONLY word lists / closed-class tables; scene_graph.py holds the
conventions and the parsing machinery. Post-freeze, a change here is a
LEXICON row (coverage of an existing convention — allowed, pin it); a
change to scene_graph.py's rule code is a convention change (frozen).
Every table keeps its original comment, which cites the blind-probe or
finding that introduced it.
"""

from __future__ import annotations

from typing import Tuple

from show_and_tell_tpu_torch.metrics.meteor import porter_stem

DETERMINERS = frozenset(
    """a an the this that these those some any each every no all both
    his her its their my your our another other several few many most much
    either neither
    one two three four five six seven eight nine ten""".split()
)
# either/neither: pure determiners ("trees on EITHER SIDE of the road" —
# the side carries no 'either' attribute) — blind-11 finding
# number words double as count attributes (SPICE keeps counts)
NUMBERS = frozenset(
    "one two three four five six seven eight nine ten".split()
)
# digit -> word normalization so numeral and spelled-out counts match
_DIGIT_WORDS = {
    "1": "one", "2": "two", "3": "three", "4": "four", "5": "five",
    "6": "six", "7": "seven", "8": "eight", "9": "nine", "10": "ten",
}
# modal auxiliaries carry no scene content; dropped ONLY when immediately
# followed by (optionally negated) "be" — "a clock CAN BE seen on the
# wall" reduces to the plain passive the framing filter already handles.
# The noun readings ("a trash CAN", "a CAN of soda") never precede "be",
# so the guard keeps them intact.
_MODALS = frozenset("can could may might will would must shall".split())
# raising verbs pass their semantics through ("a man APPEARS TO be
# talking on his phone" -> the man talks): the "<raise> to" bigram is
# dropped so the embedded VP binds to the subject directly. Without a
# following "to" these stay ordinary tokens ("appears in the doorway").
_RAISING_VERBS = frozenset(
    """appears appear appeared seems seem seemed appearing seeming
    learn learns learning learned""".split()
)  # learn-to is control, not raising, but the scene semantics pass
# through the same way ("helping a child LEARN TO ride a bike" -> the
# child rides); without "to" the learn-family are ordinary verbs
# phrasal verbs whose "on"/"off" is a particle, not a locative: "putting
# ON a helmet" -> (woman, put, helmet), never (woman, on, helmet). Only
# the particle directly after the verb is dropped — "putting a bowl ON
# the table" keeps its real locative. Unambiguously ACTIVE forms
# (-ing/-s plus the preterites took/turned/tried) always drop; the bare
# forms are split off below because in caption text they are usually
# reduced-relative participles whose "on" is a true locative ("food PUT
# ON a plate" -> (food, on, plate)) — they drop the particle only right
# after infinitival "to" ("ready to put ON a coat").
_PHRASAL_VERBS = frozenset(
    """puts putting takes taking took tries trying tried
    turns turning turned""".split()
)
_PHRASAL_BARE = frozenset("put take try turn".split())
# object pronouns after a preposition: the phrase is anaphoric ("in it",
# "around them") and adds no scene content — dropped in the pre-pass
_ANAPHORS = frozenset("it them him her".split())
# -ing verbs that do not need an animate agent: after "with" they stay on
# the with-object even when it is inanimate ("a table with candles
# BURNING" -> the candles burn; "a wall with pictures HANGING")
_EVENT_ING = frozenset(
    """burning hanging flying floating glowing growing shining melting
    boiling steaming waving spinning blooming dripping
    rising falling running coming crashing pouring flowing drifting
    billowing swaying""".split()
)  # rising/coming/falling/crashing/... added by a verify-drive finding
# (round-3 session-9): "a house with smoke COMING out of the chimney"
# had the HOUSE coming; "a beach with waves CRASHING" had the beach crash
# determiners that can open an item of an asyndetic list ("a stove a sink
# and a refrigerator" — PTB strips the commas)
_LIST_DETS = frozenset("a an the".split()) | NUMBERS
# s-final ATTRIBUTIVE nouns: never the left edge of a bare-plural list
# juncture ("TENNIS shoes and socks" is a compound plus one list item)
_S_ATTRIBUTIVE = frozenset("tennis sports news electronics".split())
# fixtures/appliances that NEVER compound with each other: a bare
# singular juncture between two different ones is a comma-stripped list
# ("a bathroom with a TOILET SINK and bathtub" -> toilet, sink, bathtub).
# General singular junctures stay compounds ("a TRAIN STATION").
_LIST_NOUNS = frozenset(
    """toilet sink bathtub shower tub urinal
    stove oven refrigerator fridge microwave dishwasher freezer""".split()
)
# sentinel for the "in front of" collapse: non-alpha so it can NEVER
# collide with the ordinary noun/adjective uses of "front" ("front seat",
# "front wheel" — common in captions); emitted in tuples as "front"
_FRONT = "\x00front"

PREPOSITIONS = frozenset(
    """in on at by of over under above below between among through during
    before after near against into onto upon inside outside behind beside
    along across around atop underneath beneath past beyond within without
    with to from off down up toward towards amid amidst for out
    like left_of right_of""".split()
) | {_FRONT}
# left_of/right_of: sentinels from the "to the left/right of" collapse —
# they relate like any preposition and normalize to left/right in tuples
# "out" is a preposition ONLY via the "out of" collapse or right after a
# look-type verb ("looking OUT the window"); bare "out" anywhere else is
# a verb particle or adverb and is dropped in the pre-pass ("sticking OUT
# its tongue", "blowing OUT candles", "a man working OUT at the gym")
# compound-prep collapse targets must be members of PREPOSITIONS or the
# collapsed token derails the whole clause (golden-set finding,
# benchmarks/spice_parser_eval — the original "front" bug)
COPULAS = frozenset("is are was were be been being 's am".split())
CONJUNCTIONS = frozenset("and or but".split())
SKIP = frozenset(
    """there it he she they i you we who which that as when where
    very really quite just also not n't about than together nearby
    himself herself itself themselves indoors outdoors
    what anyone anybody nobody""".split()
)  # indoors/outdoors: bare adverbs, no scene tuple — blind-8 finding.
# "what" is a wh-word, never an entity ("WHAT appears to be a sandwich"
# passes through to the sandwich); anyone/anybody/nobody are indefinite
# pronouns with no scene referent ("a bench not occupied BY ANYONE") —
# blind-11 findings
# "overhead" is handled positionally in the pre-pass: adverb when bare
# ("seagulls flying OVERHEAD"), attribute before a noun ("the OVERHEAD
# compartment") — fix
# "while"/"whilst" open a subordinate VP whose subject is the CLAUSE
# subject ("holding an umbrella WHILE STANDING in the rain" -> the woman
# stands): handled as a clause boundary in the token loop, not skipped
SUBORDINATORS = frozenset(("while", "whilst"))
# "than" is comparative syntax, not scene content: "a cake larger THAN a
# plate" -> (cake, larger) + separate plate object, no relation tuple

Tuple3 = Tuple[str, ...]

# post-nominal adjectives ("a bowl FULL of oranges", "a cake LARGER than a
# plate"): a closed list so _flush_np never mistakes one for the NP head —
# comparatives and quantity adjectives are the forms captions put after the
# noun
POST_ADJS = frozenset(
    """full empty half larger smaller bigger taller longer shorter higher
    lower older younger wider deeper darker lighter brighter high
    fresh hot warm""".split()
)

# nouns that cannot be the agent of a verb relation (body parts, clothing,
# accessories): "a man with a BEARD holding a phone" — the gerund's subject
# re-anchors past these to the possessor ("a man"), matching the reading a
# dependency parse + animacy would give. Closed caption-domain list.
NON_AGENT = frozenset(
    """beard mustache moustache hair hat cap helmet shirt tshirt jacket
    coat dress skirt tie suit uniform glasses sunglasses scarf glove
    gloves backpack purse watch necklace bracelet outfit jersey vest
    sweater hoodie jeans pants shorts shoes boots sneakers
    skis ski snowboard skateboard surfboard racket racquet""".split()
)

# location nouns: a passive "by" phrase whose object is one of these is
# LOCATIVE, not agentive ("a picture hung BY THE WINDOW" -> (picture, by,
# window), not (window, hang, picture)); and a "with" after a locative on
# one of these re-anchors to the clause subject ("a dog running on the
# beach WITH a ball" -> the dog has the ball, not the beach)
PLACE_NOUNS = frozenset(
    """beach street field park grass road sidewalk water ocean sea lake
    river pool sky ground floor wall window door fence tree building
    mountain hill shore curb corner roof ceiling kitchen bathroom bedroom
    room station market harbor dock bridge background foreground
    yard backyard courtyard playground garden court stadium zoo forest
    city town square plaza trail snow air restaurant
    rain sunshine shade dark distance
    game games party parade festival fair wedding match event show
    concert ceremony carnival rodeo race rally tournament competition
    store garage driveway highway porch balcony nest place
    table desk counter shelf bench couch sofa chair bed stool mat rug
    seat""".split()
)
# nest: a location like any furniture noun ("feeding its chicks IN A
# NEST" — the bird is in the nest, the VP-adjunct convention); place:
# the ordinal idiom's head ("crossing the finish line IN FIRST PLACE" —
# the runner is in first place) — blind-11 findings

# container nouns: "a PLATE of food on a table" — a locative after the
# "of" object re-anchors to the container (the plate is on the table);
# group/photo heads keep the of-object ("a group of people AROUND a
# table", "a photo of a man ON a horse")
CONTAINER_NOUNS = frozenset(
    """plate bowl vase cup glass basket box bottle pot pan tray jar bag
    mug bucket pitcher crate carton suitcase backpack""".split()
)
# membership is checked on the NORMALIZED head so plural containers
# re-anchor like their singulars ("PLATES of food to a table" — the
# plates go, exactly as "a PLATE of food" does) — blind-10 finding
_CONTAINER_NORMED = frozenset(porter_stem(w) for w in CONTAINER_NOUNS)
# spanning structures: "crossing a bridge OVER a river" — the bridge
# spans the river (NP-modifier attachment), never the crossing agent's
# path, so the motion-prep agent re-anchor skips these heads for "over"
# — blind-10 finding
_SPANNING_NORMED = frozenset(
    porter_stem(w) for w in "bridge overpass walkway archway viaduct".split()
)
# non-transfer action verbs whose benefactive "for" anchors to the AGENT
# ("a crossing guard STOPPING traffic FOR children" -> the guard acts for
# the children); transfer/creation verbs keep the object reading ("buying
# flowers FOR his wife" -> the flowers are for the wife) — blind-10
_BENEFACTIVE_AGENT_NORMED = frozenset(
    porter_stem(w) for w in "stop block".split()
)
# lamp-compound premodifiers: "STREET lights", "TRAFFIC lights",
# "CHRISTMAS lights up on the roof" are compound nouns, never the phrasal
# verb "light up" — the rewrite below must not fire after one of these
# (adversarial-test finding on the blind-9 rewrite: 'christmas lights up
# on the roof' had become (christmas, light, roof))
_LAMP_PREMODS = frozenset(
    """street traffic christmas ceiling neon city brake tail fairy
    holiday patio porch landing runway""".split()
)
# placement participles subcategorize their locative: under NEGATION the
# PP is the denied argument, not a surviving adjunct ("a sign that has
# not been PLACED on the wall" — the sign is NOT on the wall; contrast
# "a bed that has not been MADE in a messy bedroom", where the bedroom
# survives). Adversarial-test refinement of the blind-9 negated-passive
# locative-survival rule.
_PLACEMENT_NORMED = frozenset(
    porter_stem(w) for w in
    """park parked place placed put set leave left hang hung mount
    mounted install installed position positioned dock docked moor
    moored store stored keep kept""".split()
)

# photographic-framing participles: describe how the image was taken, not
# the scene ("a man SEEN through a window") — never emitted as attributes
FRAMING_PARTICIPLES = frozenset(
    "seen shown pictured photographed displayed featured".split()
)
# conative verbs carry no scene content of their own ("a man TRYING to
# catch a ball" -> (man, catch, ball) only). Deliberately narrow: "going"/
# "getting"/"starting" are genuine motion/activity attributes in caption
# text ("a train GOING down the tracks" keeps (train, go))
ASPECTUAL_VERBS = frozenset(
    "trying tries attempting attempts".split()
)
# light verbs: the semantic weight sits in their OBJECT ("does a trick on
# a skateboard"), so a locative after that object belongs to the agent,
# not the object ((man, on, skateboard), never (trick, on, skateboard))
LIGHT_VERBS = frozenset(
    "do does doing did done perform performs performing performed".split()
)
# get-forms: passive/causative auxiliaries, never a scene relation — the
# pre-pass drops one before a bare participle ("getting HIT by a wave");
# before an object the completion sites advance anchoring state without
# emitting ("a child GETTING his face painted at a fair" -> (face,
# painted) + (child, at, fair), no (child, get, face)) — blind-11
_GET_FORMS = frozenset("getting gets get got".split())
# exemplification: "foods INCLUDING pizza and salad" lists examples of an
# NP already in the graph — the examples are bare entities, with no
# relation to the listing head and no distribution of its pending
# relation onto them — blind-13 finding
_EXEMPLAR = frozenset("including includes".split())
# vague large quantifiers pass through to their of-object like many/a-few
# drop ("DOZENS OF seagulls" -> the seagulls; no (dozen, of, seagull))
# — blind-13 finding
_VAGUE_LARGE = frozenset("dozens hundreds thousands scores".split())
# "fit(s) in/into X" is a light locative — the verb asserts nothing but
# containment, so it drops and the preposition anchors to the subject
# ("a kitten so small it FITS IN the palm" -> (kitten, in, palm), no
# (kitten, fit)) — blind-13 finding
_FIT_FORMS = frozenset("fit fits fitting".split())
# ditransitive verbs: in the double-object frame (V + animate recipient +
# det theme) the relation targets the THEME ("handing a woman A SLICE"
# -> (man, hand, slice)); the recipient stays a bare entity. The
# prepositional frame is untouched ("gives food TO a man" keeps
# (woman, gives, food) + (food, to, man)) — blind-11 finding
_DITRANS = frozenset(
    """give gives giving gave given hand hands handing handed
    feed feeds feeding fed offer offers offering offered
    serve serves serving served toss tosses tossing tossed
    throw throws throwing threw thrown pass passes passing passed
    show shows showing showed shown bring brings bringing brought
    buy buys buying bought""".split()
)
# event-noun themes rewrite the light-verb frame entirely: "giving her
# mother A HUG" -> (girl, hug, mother), the hug is the relation, not an
# entity — blind-11 finding
_DITRANS_EVENT = frozenset("hug hugs kiss kisses".split())


# irregular plurals the Porter stemmer cannot reduce — the lemma step
# CoreNLP applies before SPICE's WordNet lookup (Anderson et al. parse on
# lemmas, so "two feet" and "two foot" build the SAME tuple). Suppletive
# forms (men/women/children) are instead linked in metrics/synonyms.py;
# this map covers the inflectional classes: vowel-change plurals and the
# f->ves class. "leaves"/"halves" also have (rare in captions) finite-verb
# readings that now normalize to the noun lemma — accepted, documented in
# docs/PARITY.md.
_IRREGULAR_NOUNS = {
    "feet": "foot", "teeth": "tooth", "geese": "goose", "mice": "mouse",
    "oxen": "ox", "knives": "knife", "leaves": "leaf", "shelves": "shelf",
    "wolves": "wolf", "calves": "calf", "scarves": "scarf",
    "loaves": "loaf", "halves": "half", "thieves": "thief",
    "wives": "wife", "hooves": "hoof",
    # short -ie verbs fragment under Porter (tie/ties/tied/tying ->
    # tie/ti/ti/ty; lie/lies/lying -> lie/li/ly), so "a dog LYING on a
    # bed" and "a dog LIES on the bed" would never match — pin each
    # family to its lemma. "laid" similarly rejoins the lay family
    # (lay/lays/laying all stem to "lai" already).
    "ties": "tie", "tied": "tie", "tying": "tie",
    "lies": "lie", "lying": "lie",
    "dies": "die", "dying": "die",
    "laid": "lay",
    # irregular preterites with no shared stem ("took a picture" must
    # match "taking a picture"; Porter leaves both untouched)
    "took": "take",
    "blew": "blow",
}

ING_NOUNS = frozenset(
    """building painting ceiling clothing wedding railing awning icing
    frosting lightning landing drawing evening morning spring
    string ring wing thing king living dining""".split()
)
# -ed words that are NOT verb forms. The morphological tests below accept
# length-4 forms ("tied", "iced") but exclude the -eed noun class
# (seed/reed/weed/...) wholesale plus these listed exceptions. "used"
# stays VERBISH: the compound-premodifier path already reads prenominal
# "a USED car" as an attribute, while the reduced relative "a knife USED
# to cut vegetables" needs the participle reading (an ED_NOUNS entry made
# "used" a noun HEAD there, demoting the knife to its attribute)
ED_NOUNS = frozenset("speed breed seaweed tweed shed bed sled".split())
# common caption verbs whose base/-s forms carry no -ing/-ed marker
VERBS = frozenset(
    """sit sits stand stands walk walks run runs ride rides hold holds
    play plays eat eats drink drinks look looks watch watches wear wears
    carry carries jump jumps fly flies drive drives sleep sleeps hang hangs
    wait waits pose poses smile smiles talk talks read reads throw throws
    catch catches swing swings hit hits kick kicks lean leans graze grazes
    stare stares gaze gazes rest rests float floats swim swims climb climbs
    pull pulls push pushes serve serves laugh laughs surf surfs ski skis
    skate skates chase chases sets does take takes
    feed feeds hide hides cut cuts point points pet pets
    cross crosses bend bends lick licks grab grabs reach reaches
    see sees appear appears board boards tie ties put puts
    lie lies lay lays turn turns try tries took
    blow blows blew stick sticks lean leans say says said
    make makes learn learns
    wash washes pour pours fill fills toss tosses stir stirs hug hugs
    kiss kisses bite bites lift lifts drag drags paint paints
    draw draws spray sprays pick picks place places drop drops
    wrap wraps shake shakes peel peels slice slices wave waves
    juggle juggles squeeze squeezes tow tows brush brushes fix fixes
    crash crashes splash splashes
    opens closes cleans dries smells touches steers
    surround surrounds enclose encloses encircle encircles
    borders flanks
    sail sails rise rises bark barks glow glows shine shines
    flow flows drift drifts
    bring brings give gives lead leads follow follows pass passes
    help helps sniff sniffs stretch stretches paddle paddles
    come comes""".split()
# NB: finite -s rows above were a systematic audit finding (a man WASHES
# a ball parsed as an appositive); adjective-dominant bare forms
# (open/close/clean/dry/smell/touch) are deliberately NOT added — only
# their unambiguous -s forms are. Noun-ambiguous forms (wave/waves,
# drops, slices, ...) are paired with S_NOUN_AFTER_CONJ entries so
# compounds keep the noun reading ("a large WAVE", "rain DROPS").
)
# motion preps: their object is a TARGET, not a holder — a following
# "with" re-anchors to the clause subject ("cutting INTO a cake WITH a
# knife" -> the woman has the knife, not the cake)
MOTION_PREPS = frozenset(
    """into onto through across toward towards past over down up off
    out""".split()
)
# coverings/materials: as a locative object they describe a STATE of the
# subject, not a place — a following locative re-anchors to the subject
# ("a stop sign covered in SNOW on a street corner" -> the sign is on the
# corner). Several double as PLACE_NOUNS (snow/rain) for the gerund
# re-anchor; this set governs only the locative CHAIN.
MATERIAL_NOUNS = frozenset(
    """snow mud dirt sand dust rain water ice grass paint chocolate
    frosting icing glaze sauce powder foam
    row line circle semicircle formation
    air sky leash display""".split()
)  # row/line/...: configurations, same state-not-place chain behavior
# ("motorcycles parked in a ROW on the street" -> they are on the street);
# air/sky/leash: media and tethers chain the same way ("flying through
# the AIR on a snowboard" -> the man is on the snowboard)
# ambience objects (lighting/weather/depth/time-of-day): as the OBJECT of
# a chained locative they describe the scene's subject, not the nearest
# noun ("two cats on a sill IN THE SUN" -> the cats are in the sun;
# "walking along the beach AT SUNSET")
AMBIENT_NOUNS = frozenset(
    """sun shade sunlight sunshine fog mist dark darkness distance
    background foreground moonlight
    sunset sunrise dusk dawn night noon daytime nighttime
    day days morning afternoon evening winter summer spring autumn""".split()
)  # temporal heads ("on a RAINY DAY", "on a summer morning") describe the
# scene like weather/lighting do: the locative re-anchors to the clause
# subject past a with-object ("people walking with umbrellas ON A RAINY
# DAY" -> the people are out on the day, not the umbrellas) — blind-13
# EVENT nouns (a subset of PLACE_NOUNS): as a chained locative's object
# they situate the scene's SUBJECT, not the nearest noun ("a man does a
# trick on his skateboard AT A COMPETITION" -> the man is there)
EVENT_NOUNS = frozenset(
    """game games party parade festival fair wedding match event show
    concert ceremony carnival rodeo race rally tournament
    competition""".split()
)
# rideable vehicles/mounts: as a chained "on"-object they carry the
# chain's SUBJECT ("a man riding up a hill ON A BIKE" -> the man is on
# the bike, not the hill)
RIDEABLE_NOUNS = frozenset(
    """bike bikes bicycle bicycles motorcycle motorcycles skateboard
    surfboard snowboard horse horses skis sled scooter skates
    wheelchair lift""".split()
)  # lift: "riding up the mountain ON A SKI LIFT" carries the rider
# hand tools/implements: a determined with-object after an animate
# agent's inanimate verb object is an INSTRUMENT of the agent ("cutting
# a birthday cake WITH A PLASTIC KNIFE" -> the woman has the knife),
# matching the pinned cutting-into convention; non-tool with-objects
# keep nearest attachment ("a mirror reflecting a bed WITH A STRIPED
# COMFORTER" -> the bed has it) — blind-6 finding
TOOL_NOUNS = frozenset(
    """knife knives fork forks spoon spoons scissors tongs spatula whisk
    ladle chopsticks bat bats racket racquet club clubs paddle paddles
    brush brushes comb pen pencil marker crayon hammer saw drill shovel
    rake hose sponge camera phone""".split()
)
# body-part nouns: a POSSESSED body part as a verb's object passes a
# following locative to its owner ("brushing HIS TEETH in front of a
# mirror" -> the boy is at the mirror — the teeth go where the boy
# goes), unless the locative's own object is also a body part ("wearing
# a hat on her head" keeps nearest attachment). Distinct from NON_AGENT:
# that set mixes clothing/equipment whose locatives stay local ("a hat
# ON HER HEAD"). — blind-6 finding
BODY_PART_NOUNS = frozenset(
    """head face hand hands arm arms leg legs foot feet mouth nose ear
    ears eye eyes teeth tooth tail paw paws neck shoulder shoulders
    finger fingers thumb knee knees lap wrist ankle elbow chest belly
    stomach hair fur mane whiskers tongue beak wing wings hoof hooves
    back""".split()
)
# aggregate/configuration heads whose "of"-object is the real located
# thing: "dancing under a STRING OF LIGHTS" situates the couple under
# the lights — the locative passes through to the of-object while the
# (string, of, lights) partitive still holds. Deliberately narrow: rows/
# lines/piles are plausible located entities themselves. — blind-6
AGGREGATE_OF_NOUNS = frozenset("string strings strand strands".split())
# quality "of"-objects: pure PROPERTIES of the head ("umbrellas of
# different COLORS", "boxes of various SIZES") — they can never be verb
# agents or located entities, so verbs and locatives after them re-anchor
# to the of-head. — blind-9 finding
QUALITY_OF_NOUNS = frozenset(
    """color colors size sizes shape shapes variety varieties kind kinds
    type types sort sorts age ages height heights length lengths""".split()
)
# -ing verbs that need an ANIMATE agent: after an active verb's INANIMATE
# object they re-anchor to the verb's subject ("a man riding a motorcycle
# WEARING a black helmet" -> the man wears it; "a teddy bear wearing a
# red bow SITTING on a bed" -> the bear sits). An animate object keeps
# nearest attachment ("a dog chasing a cat WEARING a collar").
_AGENT_ING = frozenset(
    """wearing holding carrying eating drinking smiling smoking talking
    reading sitting standing waiting laughing watching looking""".split()
)
# theme-motion verbs: the OBJECT moves, not the agent, so a motion prep
# after the object keeps nearest attachment ("pouring coffee INTO a mug"
# -> the coffee goes in, not the woman)
_THEME_MOTION = frozenset(
    """pour throw toss drop place put load spill dip dunk insert stuff
    squeeze sprinkle scatter cast bring pass""".split()
)  # cast: "a tree CASTING a shadow on the grass" — the shadow lands;
# bring/pass: "brings a ball TO its owner" — the ball goes (verify-drive)
# stative covering participles: "<subj> COVERED in X" makes X a covering,
# not a location — a locative chained after it re-anchors to the covered
# subject ("a refrigerator covered in magnets IN A KITCHEN")
_STATIVE_COVER = frozenset(
    """covered wrapped coated filled decorated topped surrounded drenched
    splattered smothered adorned stuffed""".split()
)
# stemmed lookups, matching the normalized space tuples are stored in
_THEME_NORMED = frozenset(porter_stem(w) for w in _THEME_MOTION)
# projected/immaterial entities that exist only AT their location: a
# locative after one as a verb object stays on the object ("casting a
# shadow ON THE GRASS", "shining a light ON THE WALL") — blind-7
_PROJECTED_NOUNS = frozenset(
    "shadow shadows light reflection reflections glow beam beams".split()
)
# depiction heads: their of-content keeps its own VERBS ("a statue of a
# man RIDING a horse" — the man rides) but the PHYSICAL object holds the
# scene locative ("a statue ... IN A CITY SQUARE") — blind-8 finding.
# Deliberately not CONTAINER_NOUNS: containers re-anchor gerunds too.
_DEPICTION_NOUNS = frozenset(
    """statue statues sculpture sculptures figurine figurines carving
    carvings mural murals""".split()
)
# enclosure participles: the by-object IS the surrounder even when it is
# a place/structure noun ("a field SURROUNDED BY a wooden fence" inverts
# to (fence, surround, field) — the active is "a fence surrounds the
# field"), overriding the locative-'by' escape that "a picture hung BY
# THE WINDOW" needs — blind-7 finding
_ENCLOSURE_PARTICIPLES = frozenset(
    """surrounded enclosed encircled bordered ringed flanked framed
    lined""".split()
)
# goal verbs: the OBJECT'S location is the point of the clause ("trying
# to REACH a cookie on the counter" — the cookie is on the counter, the
# toddler is not), so the place re-anchor is exempt — blind-7 finding
_GOAL_NORMED = frozenset(
    porter_stem(w) for w in "reach reaches reaching grab grabs grabbing "
    "grabbed".split()
)
_STATIVE_NORMED = frozenset(porter_stem(w) for w in _STATIVE_COVER)
# attachment participles: their subject stays the located thing through a
# chained locative ("a mirror MOUNTED on a wall above a sink" -> the
# mirror is above the sink) — blind-9 finding
# transformation participles whose "into"-object is a RESULT, not a goal
# location: a PLACE locative after that object re-anchors to the
# transformed subject ("a sandwich CUT INTO two halves ON A PLATE" ->
# the sandwich is on the plate, not the halves) — blind-13 finding
_TRANSFORM_NORMED = frozenset(
    porter_stem(w) for w in "cut sliced divided split chopped folded".split()
)
_MOUNT_NORMED = frozenset(
    porter_stem(w) for w in
    "mounted hung attached fixed fastened installed bolted".split()
)
# color words: "a fire hydrant painted RED AND WHITE" — a verb's "object"
# that is all colors is really a list of subject attributes, never an NP
COLOR_WORDS = frozenset(
    """red orange yellow green blue purple pink brown black white gray
    grey tan beige gold silver maroon navy teal turquoise""".split()
)
# size adjectives — the SPICE "Size" subcategory filter: the Java scorer's
# -subset report buckets attribute tuples into Color/Cardinality/Size, and
# the reference wrapper surfaces those per-image score sets verbatim
# (pycocoevalcap/spice/spice.py:66,78-91)
SIZE_WORDS = frozenset(
    """big small large little tiny huge giant enormous massive tall short
    long wide narrow thick thin miniature oversized""".split()
)
# predicate adjectives that can follow a verb bare ("a cat curled up
# ASLEEP on a sofa"): subject attributes, never an object NP — grouped
# with the color-list intercept below
# "high"/"low" cover the adverbial uses ("kites flying HIGH in the sky");
# open/closed/empty cover resultative positions ("a laptop sitting OPEN
# on a table"): as a verb's whole "object" they are subject attributes,
# not entities
PRED_ADJS = frozenset(
    "asleep awake alone high low open closed empty".split()
)

# degree-frame adjectives: state adjectives that appear in "too ADJ to" /
# "as ADJ as" / "so ADJ that" but are not resultative positions
# (PRED_ADJS) or NP-internal coordinators (ADJ_COORD). Kept separate so
# the resultative rule's narrow lexicon is untouched — blind-14 coverage
# fix of the blind-13 comparative conventions
_DEGREE_ADJS = frozenset(
    """slow fast tired scared afraid nervous busy sleepy hungry thirsty
    weak strong proud shy eager happy sad angry calm quiet loud""".split()
)

# manner adverbs an unrealized infinitive can end with ("too excited to
# sit STILL"): swallowed with the infinitive, never a surviving object
_INF_MANNER_ADVERBS = frozenset(
    "still quietly alone upright straight patiently".split()
)

# animate nouns — plausible POSSESSORS for the possessive-instrument rule
# below ("photographing a woman with HER dog": the woman can own the dog,
# so the phrase keeps nearest attachment; "spraying water with ITS trunk"
# has an inanimate object, so the possessive must refer to the agent)
ANIMATE_NOUNS = frozenset(
    """man men woman women boy boys girl girls child children kid kids
    person people lady ladies guy guys baby babies couple player players
    rider surfer skier skater chef cook officer worker crowd family
    toddler toddlers infant infants passenger passengers snowboarder
    snowboarders hiker hikers owner owners teenager teenagers tourist
    tourists swimmer swimmers dancer dancers climber climbers biker
    bikers mother mothers father fathers grandmother grandfather
    son sons daughter daughters brother brothers sister sisters
    customer customers waiter waiters waitress waitresses
    runner runners driver drivers cyclist cyclists zookeeper zookeepers
    reporter reporters journalist journalists photographer photographers
    jockey jockeys baker bakers barber barbers vendor vendors clown
    clowns farmer farmers fisherman fishermen pilot pilots sailor
    sailors nurse nurses doctor doctors teacher teachers student
    students artist artists musician musicians singer singers painter
    painters firefighter firefighters policeman policemen soldier
    soldiers athlete athletes goalie goalies
    skateboarder skateboarders jogger joggers
    shopper shoppers pedestrian pedestrians spectator spectators
    dog dogs cat cats horse horses elephant elephants giraffe giraffes
    zebra zebras bear bears bird birds cow cows sheep monkey monkeys
    animal animals
    pigeon pigeons duck ducks seagull seagulls gull gulls swan swans
    chicken chickens kitten kittens puppy puppies goat goats pig pigs
    lamb lambs deer squirrel squirrels rabbit rabbits""".split()
)
# adjectives that legitimately coordinate INSIDE an NP ("black AND white
# cat", "a big and small dog"): closed lexicon — a non-adjective before
# "and" is NP coordination instead ("a bride AND groom" is two objects,
# not one groom with a bride attribute)
ADJ_COORD = COLOR_WORDS | POST_ADJS | frozenset(
    """big large small little old young new tall short long wide narrow
    bright dark light heavy thin thick soft hard clean dirty wet dry
    open closed striped spotted fluffy furry shiny rusty broken fresh
    round square modern vintage colorful plain fuzzy""".split()
)
# the full predicate-adjective lexicon — degree/comparative rewrites
# ("as BIG as", "too HEAVY to", "so HIGH that") and the conjunction-
# boundary predicate binding test against it — blind-13; degree-frame
# state adjectives included so "too SLOW to jump onto the counter"
# predicate-binds instead of minting a 'slow' entity — blind-14
_PRED_ADJ_SET = ADJ_COORD | PRED_ADJS | SIZE_WORDS | _DEGREE_ADJS

# verbs whose NOUN reading wins right after a conjunction ("food and
# DRINKS", "dogs and PETS", "a park with slides and SWINGS", "a suit and
# TIE"): close_np treats a lone one there as an NP, while the verb
# reading stays everywhere else ("a man DRINKS coffee", "a woman PETS a
# dog", "a man TIES his shoe")
S_NOUN_AFTER_CONJ = frozenset(
    """drinks pets swings swing skis skates tie ties board boards
    drink
    wave waves slice slices drop drops wrap wraps lift lifts
    peel peels paint paints pick picks place places bite bites
    shake shakes brush brushes spray sprays kiss kisses wash
    steers
    sail sails bark barks glow glows rise rises flow flows
    paddle paddles stretch stretches""".split()
)  # stretch/stretches: the compound-tail ANIMATE guard separates "a cat
# STRETCHES" (verb) from "a long STRETCH of beach" (noun) — verify-drive
# -s forms whose canonical clause SUBJECT is inanimate ("a boat SAILS",
# "smoke RISES"): the compound-tail animate guard cannot separate them
# from true compounds ("white SAILS"), so their noun reading is allowed
# only in OBJECT position (a pending relation / after a conjunction) —
# subject position keeps the finite-verb reading. Blind-9 finding.
_S_NOUN_OBJECT_ONLY = frozenset("sails rises glows flows paddles".split())
# transitive verb forms whose BARE object may itself be a verb-lexicon
# word ("holding DRINKS", "carrying two PADDLES", "serving DRINKS on a
# tray"): the trailing-verb strip keeps an S_NOUN tail as the object
# noun when one of these precedes it with subject content before it.
# Deliberately a closed transitive list — intransitives must NOT license
# the noun reading ("a woman standing WAVES at the camera" keeps the
# verb-chain reading). Verify-drive finding (round-3 session-9).
_TRANS_OBJ = frozenset(
    """holding carrying serving selling making preparing pouring
    offering delivering bringing grabbing enjoying sharing balancing
    stacking holds carries serves sells makes prepares pours offers
    delivers brings grabs enjoys shares balances stacks""".split()
)
# bare sport verbs that act as COMPOUND PREMODIFIERS of a verbish tail
# ("a SKI lift", "a SKI jump", "a SURF board"): without this the tail is
# stripped as a trailing verb because the premodifier itself is verbish,
# inverting the compound head ((ski, lift) instead of (lift, ski)).
# Deliberately NOT in S_NOUN_AFTER_CONJ — that set's after-conjunction
# noun reading would break verb chains ("people ski and SURF").
_SPORT_PREMODS = frozenset("ski skate surf".split())
# extra verbish tails valid ONLY under a sport premodifier ("a ski JUMP");
# unlisted elsewhere because plural subjects outside ANIMATE_NOUNS
# ("skiers JUMP off a ramp") must keep the verb reading.
_SPORT_TAILS = frozenset("jump jumps run runs".split())

# compound prepositions collapsed to one token before chunking
_COMPOUND_PREPS = (
    (("on", "top", "of"), "on"),
    (("in", "front", "of"), _FRONT),
    (("in", "the", "middle", "of"), "amid"),
    (("in", "the", "center", "of"), "amid"),
    (("in", "the", "centre", "of"), "amid"),
    (("in", "the", "midst", "of"), "amid"),
    # reciprocal/adverbial idioms: no scene tuple ("standing next to each
    # other", "running side by side") — must precede the ("next","to")
    # collapse so the 4-gram wins
    (("next", "to", "each", "other"), None),
    (("next", "to", "one", "another"), None),
    (("side", "by", "side"), None),
    (("back", "to", "back"), None),
    # posture idiom: no scene tuple ("a man crawling ON ALL FOURS in the
    # grass" — the man is in the grass) — blind-11 finding
    (("on", "all", "fours"), None),
    # two-prep reciprocals collapse whole so the first prep never
    # strands ("seated ACROSS FROM EACH OTHER sharing a dessert" — the
    # generic P+reciprocal drop left a dangling 'across' that captured
    # the following gerund as its object) — blind-12 finding
    (("across", "from", "each", "other"), None),
    (("across", "from", "one", "another"), None),
    # hedge partitives pass through to the downstream noun like "one of
    # the" ("SOME KIND OF bird perched on a wire" — the bird perches) —
    # blind-11 finding
    (("some", "kind", "of"), None),
    (("some", "sort", "of"), None),
    (("some", "type", "of"), None),
    # relational direction phrases: a real SPICE relation, not a 'left'
    # entity ("a vase sits TO THE LEFT OF the sink" -> (vase, left,
    # sink)); bare "on the left" (no 'of') keeps its pinned locative
    # reading ("the man on the left is smiling") — blind-11 finding
    (("to", "the", "left", "of"), "left_of"),
    (("to", "the", "right", "of"), "right_of"),
    (("on", "the", "left", "side", "of"), "left_of"),
    (("on", "the", "right", "side", "of"), "right_of"),
    (("next", "to"), "near"),
    (("close", "to"), "near"),
    # photographic framing prefix, not scene content: drop it so
    # "a close up of a plate" parses as the plate NP
    (("close", "up", "of"), None),
    (("close", "of"), None),  # after PTB 'up' stripping variants
    # partitives whose head is the downstream noun: "ONE OF THE zebras is
    # drinking" -> the zebra drinks; "A PAIR OF scissors" is lexically
    # scissors
    (("one", "of", "the"), None),
    (("two", "of", "the"), None),
    (("some", "of", "the"), None),
    # "no one" is the indefinite pronoun (nobody): no scene entity ("NO
    # ONE sitting on the bench" had made 'one' an NP head) — fix
    # alongside the blind-11 anyone/anybody/nobody SKIP entries
    (("no", "one"), None),
    (("a", "pair", "of"), None),
    (("a", "couple", "of"), None),
    # "cut IN HALF" is a state of the cut object, not a location: drop the
    # phrase so a following locative attaches to the object itself
    (("in", "half"), None),
    # additive connective == NP coordination ("a woman AS WELL AS a child
    # sitting on a bench" distributes like "and"); must collapse before
    # the SKIP filter eats the "as" tokens and strands "well"
    (("as", "well", "as"), "and"),
    # "along with" is the same additive connective ("a man ALONG WITH his
    # dog sitting on a porch" -> both sit); must precede any bare "along"
    # reading — blind-7 finding
    (("along", "with"), "and"),
    # "getting ready to X" / "preparing to X" are preparatory aspect: the
    # scene content is X itself ("a boy GETTING READY TO hit a baseball"
    # -> the boy hits), parallel to the ASPECTUAL_VERBS "trying to" drop.
    # They collapse to the _INF_TO sentinel (dropped in the next pass)
    # rather than nothing, so the phrasal-verb bare-form guard can still
    # see the infinitival context ("getting ready to put ON a coat")
    (("getting", "ready", "to"), "__inf_to__"),
    (("gets", "ready", "to"), "__inf_to__"),
    (("get", "ready", "to"), "__inf_to__"),
    # wh-infinitive complements pass through like control ("teaching his
    # daughter HOW TO ride a bicycle" -> the daughter rides) — blind-7
    (("how", "to"), "__inf_to__"),
    (("preparing", "to"), "__inf_to__"),
    (("prepares", "to"), "__inf_to__"),
    (("prepare", "to"), "__inf_to__"),
    # "out of" is always prepositional ("a cat jumping OUT OF a box");
    # collapses to a sentinel so the pre-pass can tell it apart from bare
    # particle "out" (which only survives after a look-type verb)
    (("out", "of"), "__out_of__"),
)
# sentinel for a consumed infinitival "to" (see preparatory aspect above)
_INF_TO = "__inf_to__"
# sentinel for collapsed "out of" (see above)
_OUT_OF = "__out_of__"
# bare verbs whose NOUN reading can win in compounds ("a porch SWING");
# after an infinitival "to" they are unambiguously verbs, so they rewrite
# to the -ing form — SAME Porter stem (tying/skiing pinned via
# _IRREGULAR_NOUNS), but morphologically marked so the compound-noun
# guard cannot misread "a batter getting ready to SWING" as a compound
_BARE_TO_ING = {
    "swing": "swinging", "drink": "drinking", "board": "boarding",
    "tie": "tying", "ski": "skiing", "skate": "skating",
    "pet": "petting",
}
# verbs whose bare "out" is PREPOSITIONAL ("looking OUT the window",
# "leaning OUT a car window") — for every other verb a bare "out" before
# an NP is a particle ("sticking OUT its tongue" -> (dog, stick, tongue))
_LOOK_VERBS = frozenset(
    """look looks looking looked stare stares staring stared
    peer peers peering peered gaze gazes gazing gazed
    lean leans leaning leaned""".split()
)
# verbs whose bare "up" is PREPOSITIONAL when an NP follows ("walking UP
# the stairs", "climbing UP a ladder") — for every other verb "up" is a
# particle/adverb ("HOLDING UP a pink umbrella" -> the girl holds it)
_UP_MOTION_VERBS = frozenset(
    """walk walks walking walked climb climbs climbing climbed
    go goes going went run runs running ran ride rides riding rode
    drive drives driving drove move moves moving moved
    hike hikes hiking hiked march marches marching marched
    pulled towed""".split()
)
# pulled/towed: PASSIVE motion keeps its path ("a skier being PULLED UP
# the mountain"); the active forms stay particles ("PULLING UP his
# pants", "a boat pulling up to a dock") — blind-6 finding

# irregular past participles (no -ing/-ed surface marker) -> base verb, so
# "a horse ridden by a man" aligns with "a man riding a horse" after the
# passive inversion below; Porter handles the regular -ed/-ing forms
PARTICIPLE_BASE = {
    "ridden": "ride", "driven": "drive", "eaten": "eat", "worn": "wear",
    "taken": "take", "thrown": "throw", "drawn": "draw", "held": "hold",
    "hung": "hang", "given": "give", "seen": "see", "shown": "show",
    "flown": "fly", "grown": "grow", "built": "build", "made": "make",
    "caught": "catch", "led": "lead", "fed": "feed", "lit": "light",
    "torn": "tear", "swung": "swing", "hidden": "hide", "broken": "break",
    "written": "write", "stolen": "steal", "frozen": "freeze",
    "fallen": "fall", "beaten": "beat", "woven": "weave", "risen": "rise",
    "lost": "lose", "found": "find",
    "cut": "cut",  # zero-marker participle ("a sandwich cut in half")
    "put": "put",  # zero-marker participle ("food put on a plate")
    # unmarked irregular participles that otherwise read as noun HEADS and
    # demote their true subject to an attribute ("food LAID out on a
    # table" parsed as (laid, food)). "set"/"left"/"kept" are deliberately
    # absent: their noun/direction readings dominate captions ("a SET of
    # knives", "on the LEFT"); "spread" is included — its verb reading
    # ("toys SPREAD across the floor") outweighs the buffet-noun one
    "laid": "lay", "stuck": "stick", "strewn": "strew", "sewn": "sew",
    "slid": "slide", "strung": "string", "spread": "spread",
    "hidden": "hide", "swung": "swing", "hit": "hit",
    # finite have-forms normalize to "have" so "a kitchen has cabinets"
    # and "a kitchen with cabinets"-style have-relations share a lemma
    "has": "have", "had": "have",
    # irregular 3sg forms Porter mis-stems ("does" -> "doe", "goes" ->
    # "goe") while the -ing forms stem to the true base — normalize so
    # "does a trick" and "doing a trick" share a lemma
    "does": "do", "did": "do", "done": "do", "goes": "go", "went": "go",
}
# PARTICIPLE_BASE entries that are FINITE verb forms, not premodifying
# participles — excluded from the compound-participle-NP rule
FINITE_NOT_PARTICIPLE = frozenset("has had does did goes went".split())
# participle forms that CANNOT be a finite preterite ("drawn" is only ever
# a participle; "held"/"made"/regular -ed double as past tense) — the only
# forms that license a compound NP on their own ("a horse DRAWN carriage")
STRICT_PARTICIPLES = frozenset(
    """drawn eaten written woven ridden driven given taken thrown flown
    grown broken torn hidden stolen frozen fallen beaten risen shown
    seen done""".split()
)
# premodifier nouns/adverbs that mark an AMBIGUOUS participle as a
# compound modifier rather than a clause verb: "a HAND painted sign",
# "a HALF finished meal" — vs "a WOMAN carried bags" (a clause)
COMPOUND_PREMODIFIERS = frozenset(
    """hand half home machine sun freshly newly brightly custom
    tree palm""".split()
)  # tree/palm license "a TREE LINED street" as a compound NP
