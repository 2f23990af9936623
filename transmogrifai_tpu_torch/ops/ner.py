"""Rule-based named-entity recognition: person / location / organization.

Counterpart of the reference's OpenNLP-backed tagger
(core/src/main/scala/com/salesforce/op/utils/text/
OpenNLPNameEntityTagger.scala:40-80 + OpenNLPAnalyzer loading per-language
trained models).  No trained models ship in this environment, so this is
a measured gazetteer+context tagger: capitalized-token chunking with
connector words, then per-chunk classification by ordered evidence
(honorifics, org suffix/prefix shapes, location/given-name gazetteers,
locative/personal context cues).  Accuracy is pinned by a 110-sentence
labeled fixture in tests/test_text_accuracy.py (precision/recall/F1
floors per class) - the reference's models are stronger on open-domain
text, but this tagger's quality is MEASURED, not assumed.

Scope note (documented limit): single-token chunks with no gazetteer or
context evidence are dropped - sentence-initial capitalization is
otherwise the dominant false-positive source in rule-based NER.  One
exception (round 5): a lone token that an earlier tagged person in the
SAME text introduced carries the person label (document-level surname
carry, the coreference-lite behavior trained models exhibit); tokens
never introduced stay dropped.
"""
from __future__ import annotations

import re
from typing import Optional

# -- gazetteers (compact, embedded; original lists - not lifted corpora) ----

HONORIFICS = {
    "mr", "mrs", "ms", "miss", "dr", "prof", "professor", "sir", "madam",
    "rev", "fr", "capt", "captain", "col", "gen", "lt", "sgt", "judge",
    "president", "senator", "governor", "mayor", "chancellor", "minister",
    "king", "queen", "prince", "princess", "pope", "rabbi", "imam",
}

GIVEN_NAMES = {
    # common international given names (hand-assembled)
    "james", "john", "robert", "michael", "william", "david", "richard",
    "joseph", "thomas", "charles", "christopher", "daniel", "matthew",
    "anthony", "mark", "donald", "steven", "paul", "andrew", "joshua",
    "kenneth", "kevin", "brian", "george", "edward", "ronald", "timothy",
    "jason", "jeffrey", "ryan", "jacob", "gary", "nicholas", "eric",
    "jonathan", "stephen", "larry", "justin", "scott", "brandon", "frank",
    "benjamin", "gregory", "samuel", "raymond", "patrick", "alexander",
    "jack", "dennis", "jerry", "tyler", "aaron", "henry", "peter", "adam",
    "zachary", "nathan", "walter", "harold", "kyle", "carl", "arthur",
    "roger", "keith", "jeremy", "terry", "lawrence", "sean", "christian",
    "albert", "austin", "joe", "ethan", "willie", "bruce", "ralph", "bryan",
    "eugene", "louis", "wayne", "russell", "alan", "juan", "carlos", "jose",
    "luis", "miguel", "pedro", "diego", "fernando", "jorge", "ricardo",
    "eduardo", "javier", "marco", "antonio", "giovanni", "luca", "andrea",
    "francesco", "giuseppe", "pierre", "jean", "michel", "philippe",
    "francois", "louis", "claude", "henri", "jacques", "hans", "klaus",
    "wolfgang", "jurgen", "dieter", "fritz", "otto", "karl", "heinrich",
    "ivan", "dmitri", "sergei", "vladimir", "alexei", "mikhail", "nikolai",
    "boris", "yuri", "oleg", "wei", "ming", "jun", "hiroshi", "takashi",
    "kenji", "yuki", "akira", "satoshi", "kazuo", "raj", "amit", "vijay",
    "sanjay", "rahul", "arjun", "ravi", "anil", "ahmed", "mohammed",
    "muhammad", "ali", "omar", "hassan", "ibrahim", "yusuf", "khalid",
    "mary", "patricia", "jennifer", "linda", "elizabeth", "barbara",
    "susan", "jessica", "sarah", "karen", "lisa", "nancy", "betty",
    "margaret", "sandra", "ashley", "kimberly", "emily", "donna",
    "michelle", "carol", "amanda", "dorothy", "melissa", "deborah",
    "stephanie", "rebecca", "sharon", "laura", "cynthia", "kathleen",
    "amy", "angela", "shirley", "anna", "brenda", "pamela", "emma",
    "nicole", "helen", "samantha", "katherine", "christine", "debra",
    "rachel", "carolyn", "janet", "catherine", "maria", "heather",
    "diane", "ruth", "julie", "olivia", "joyce", "virginia", "victoria",
    "kelly", "lauren", "christina", "joan", "evelyn", "judith", "megan",
    "andrea", "cheryl", "hannah", "jacqueline", "martha", "gloria",
    "teresa", "ann", "sara", "madison", "frances", "kathryn", "janice",
    "jean", "abigail", "alice", "julia", "judy", "sophia", "grace",
    "denise", "amber", "doris", "marilyn", "danielle", "beverly",
    "isabella", "theresa", "diana", "natalie", "brittany", "charlotte",
    "marie", "kayla", "alexis", "lori", "elena", "sofia", "camila",
    "valentina", "lucia", "chloe", "ingrid", "astrid", "freya", "anya",
    "natasha", "olga", "svetlana", "tatiana", "yumi", "sakura", "mei",
    "priya", "anjali", "deepa", "fatima", "aisha", "layla", "zara",
    "amara", "kofi", "kwame", "amina", "chen", "li", "wang", "yuki",
}

ORG_SUFFIXES = {
    "inc", "corp", "corporation", "ltd", "llc", "plc", "gmbh", "co",
    "company", "group", "holdings", "partners", "associates", "ventures",
    "capital", "bank", "university", "institute", "college", "academy",
    "school", "hospital", "clinic", "association", "society", "foundation",
    "trust", "agency", "ministry", "department", "committee", "council",
    "commission", "authority", "bureau", "airlines", "airways", "motors",
    "industries", "technologies", "systems", "solutions", "labs",
    "laboratories", "press", "times", "post", "journal", "herald",
    "tribune", "news", "network", "studios", "pictures", "records",
    "museum", "library", "observatory", "union", "federation", "league",
    "club", "fc", "united", "brigade", "orchestra", "choir", "theatre",
    "theater", "consortium", "cooperative", "exchange", "railways",
    "organization", "organisation", "house",
}

ORG_PREFIXES = {
    "university", "bank", "ministry", "department", "institute", "college",
    "academy", "museum", "church", "cathedral", "house", "court", "office",
}

ORG_STANDALONE = {
    # well-known organizations recognizable without a suffix
    "google", "microsoft", "apple", "amazon", "facebook", "meta", "ibm",
    "intel", "oracle", "samsung", "sony", "toyota", "honda", "volkswagen",
    "siemens", "nokia", "nestle", "unilever", "boeing", "airbus", "nasa",
    "unesco", "unicef", "interpol", "nato", "opec", "fifa", "uefa",
    "greenpeace", "toshiba", "hitachi", "huawei", "alibaba", "tencent",
    "netflix", "spotify", "twitter", "reuters", "bloomberg",
}

COUNTRIES = {
    "afghanistan", "albania", "algeria", "andorra", "angola", "argentina",
    "armenia", "australia", "austria", "azerbaijan", "bahamas", "bahrain",
    "bangladesh", "barbados", "belarus", "belgium", "belize", "benin",
    "bhutan", "bolivia", "bosnia", "botswana", "brazil", "brunei",
    "bulgaria", "burundi", "cambodia", "cameroon", "canada", "chad",
    "chile", "china", "colombia", "comoros", "congo", "croatia", "cuba",
    "cyprus", "czechia", "denmark", "djibouti", "dominica", "ecuador",
    "egypt", "eritrea", "estonia", "eswatini", "ethiopia", "fiji",
    "finland", "france", "gabon", "gambia", "georgia", "germany", "ghana",
    "greece", "grenada", "guatemala", "guinea", "guyana", "haiti",
    "honduras", "hungary", "iceland", "india", "indonesia", "iran",
    "iraq", "ireland", "israel", "italy", "jamaica", "japan", "jordan",
    "kazakhstan", "kenya", "kiribati", "kosovo", "kuwait", "kyrgyzstan",
    "laos", "latvia", "lebanon", "lesotho", "liberia", "libya",
    "liechtenstein", "lithuania", "luxembourg", "madagascar", "malawi",
    "malaysia", "maldives", "mali", "malta", "mauritania", "mauritius",
    "mexico", "micronesia", "moldova", "monaco", "mongolia", "montenegro",
    "morocco", "mozambique", "myanmar", "namibia", "nauru", "nepal",
    "netherlands", "nicaragua", "niger", "nigeria", "norway", "oman",
    "pakistan", "palau", "panama", "paraguay", "peru", "philippines",
    "poland", "portugal", "qatar", "romania", "russia", "rwanda", "samoa",
    "senegal", "serbia", "seychelles", "singapore", "slovakia", "slovenia",
    "somalia", "spain", "sudan", "suriname", "sweden", "switzerland",
    "syria", "taiwan", "tajikistan", "tanzania", "thailand", "togo",
    "tonga", "tunisia", "turkey", "turkmenistan", "tuvalu", "uganda",
    "ukraine", "uruguay", "uzbekistan", "vanuatu", "venezuela", "vietnam",
    "yemen", "zambia", "zimbabwe", "england", "scotland", "wales",
    # continents read as locations too
    "europe", "asia", "africa", "antarctica", "oceania", "australasia",
}

CITIES = {
    "london", "paris", "berlin", "madrid", "rome", "vienna", "prague",
    "warsaw", "budapest", "amsterdam", "brussels", "lisbon", "dublin",
    "athens", "stockholm", "oslo", "copenhagen", "helsinki", "moscow",
    "kyiv", "istanbul", "cairo", "lagos", "nairobi", "johannesburg",
    "casablanca", "accra", "dakar", "tokyo", "osaka", "kyoto", "seoul",
    "beijing", "shanghai", "shenzhen", "guangzhou", "hongkong", "taipei",
    "bangkok", "jakarta", "manila", "hanoi", "singapore", "mumbai",
    "delhi", "bangalore", "chennai", "kolkata", "karachi", "lahore",
    "dhaka", "tehran", "baghdad", "riyadh", "dubai", "jerusalem",
    "sydney", "melbourne", "brisbane", "perth", "auckland", "wellington",
    "toronto", "vancouver", "montreal", "ottawa", "chicago", "boston",
    "seattle", "denver", "houston", "dallas", "austin", "miami",
    "atlanta", "philadelphia", "phoenix", "detroit", "portland",
    "baltimore", "pittsburgh", "cleveland", "minneapolis", "nashville",
    "sacramento", "oakland", "honolulu", "anchorage", "barcelona",
    "valencia", "seville", "porto", "marseille", "lyon", "munich",
    "hamburg", "frankfurt", "cologne", "stuttgart", "zurich", "geneva",
    "milan", "naples", "turin", "florence", "venice", "krakow",
    "bucharest", "sofia", "belgrade", "zagreb", "riga", "vilnius",
    "tallinn", "reykjavik", "havana", "bogota", "lima", "quito",
    "santiago", "caracas", "montevideo", "brasilia", "recife",
}

US_STATES = {
    "alabama", "alaska", "arizona", "arkansas", "california", "colorado",
    "connecticut", "delaware", "florida", "hawaii", "idaho", "illinois",
    "indiana", "iowa", "kansas", "kentucky", "louisiana", "maine",
    "maryland", "massachusetts", "michigan", "minnesota", "mississippi",
    "missouri", "montana", "nebraska", "nevada", "ohio", "oklahoma",
    "oregon", "pennsylvania", "tennessee", "texas", "utah", "vermont",
    "virginia", "washington", "wisconsin", "wyoming",
}

LOCATIONS = COUNTRIES | CITIES | US_STATES
# multiword locations matched as joined lowercase chunks
LOCATION_PHRASES = {
    "new york", "los angeles", "san francisco", "san diego", "san jose",
    "las vegas", "new orleans", "salt lake city", "kansas city",
    "oklahoma city", "north carolina", "south carolina", "north dakota",
    "south dakota", "new hampshire", "new jersey", "new mexico",
    "west virginia", "rhode island", "united states", "united kingdom",
    "new zealand", "south africa", "south korea", "north korea",
    "saudi arabia", "sri lanka", "costa rica", "el salvador",
    "puerto rico", "hong kong", "buenos aires", "rio de janeiro",
    "sao paulo", "mexico city", "cape town", "tel aviv", "abu dhabi",
    "kuala lumpur", "ho chi minh city", "st petersburg", "novosibirsk",
    "czech republic", "dominican republic", "ivory coast",
    "papua new guinea", "trinidad and tobago",
}

LOCATIVE_PREPS = {
    "in", "at", "from", "near", "to", "toward", "towards", "across",
    "outside", "inside", "around", "throughout", "via", "within",
    "into", "between",
}
# capitalized temporal words are never entities (the "in June" trap)
TEMPORAL = {
    "january", "february", "march", "april", "may", "june", "july",
    "august", "september", "october", "november", "december", "monday",
    "tuesday", "wednesday", "thursday", "friday", "saturday", "sunday",
    "spring", "summer", "autumn", "winter", "today", "yesterday",
    "tomorrow", "easter", "christmas",
}
PERSON_VERBS = {
    "said", "says", "told", "asked", "replied", "argued", "wrote",
    "insisted", "claimed", "explained", "noted", "added", "stated",
    "remarked", "whispered", "shouted", "smiled", "laughed", "nodded",
    "resigned", "retired", "testified", "married", "divorced", "died",
    "born",
}
# connectors allowed INSIDE a chunk (lowercase words between capitals):
# name particles join freely; "of" joins ONLY after an org-shaped word
# ("University of X", "Ministry of Y") so "Shares of Samsung" stays two
# chunks ("and" never joins - coordination is handled by label
# inheritance in tag_entities instead)
NAME_CONNECTORS = {"de", "da", "del", "della", "van", "von", "bin", "al",
                   "la", "le", "el", "bint", "ibn", "ter", "ten"}
_OF_HOSTS = ORG_PREFIXES | ORG_SUFFIXES

_TOKEN_RE = re.compile(r"[A-Za-z][A-Za-z'&-]*|\d+|[.,;:!?()\"]")


def _is_cap(tok: str) -> bool:
    return tok[0].isupper()


def _chunks(tokens: list[str]):
    """Yield (start, end, chunk_tokens) capitalized runs; lowercase
    connector words join two capitalized stretches into one chunk."""
    i, n = 0, len(tokens)
    while i < n:
        t = tokens[i]
        if t[0].isalpha() and _is_cap(t):
            j = i + 1
            while j < n:
                tj = tokens[j]
                if tj[0].isalpha() and _is_cap(tj):
                    j += 1
                elif (
                    j + 1 < n
                    and tokens[j + 1][0].isalpha()
                    and _is_cap(tokens[j + 1])
                    and (
                        tj.lower() in NAME_CONNECTORS
                        or (
                            tj.lower() == "of"
                            and tokens[j - 1].lower() in _OF_HOSTS
                        )
                    )
                ):
                    j += 2
                else:
                    break
            yield i, j, tokens[i:j]
            i = j
        else:
            i += 1


def _norm(tok: str) -> str:
    return tok.rstrip(".").lower()


def _chunk_key(chunk: list[str]) -> str:
    return " ".join(_norm(t) for t in chunk)


def _classify(chunk: list[str], prev: list[str], nxt: list[str],
              at_sentence_start: bool) -> tuple[Optional[str], bool]:
    """Ordered evidence -> ('person'|'location'|'organization'|None,
    strong).  ``strong`` is True when a positive cue fired (honorific,
    gazetteer, suffix shape, context rule) and False for the rule-6
    multiword Title-Case person default - the document-level surname
    carry only trusts strong persons, so a default-tagged common-noun
    phrase cannot seed carries.  ``prev``/``nxt`` carry up to TWO context
    tokens each (a period may sit between an abbreviated honorific and
    the name: "Mr. Smith")."""
    toks = [_norm(t) for t in chunk]
    if toks and toks[0] == "the" and len(toks) > 1:
        toks = toks[1:]  # leading article is never class signal
    key = " ".join(toks)
    prev1 = _norm(prev[-1]) if prev else ""
    prev2 = _norm(prev[-2]) if len(prev) > 1 else ""
    next1 = _norm(nxt[0]) if nxt else ""
    next2 = _norm(nxt[1]) if len(nxt) > 1 else ""

    # 0. temporal words are never entities ("in June")
    if all(t in TEMPORAL for t in toks):
        return None, False
    # 1. honorific immediately before (possibly across its period:
    #    "Mr. Smith" tokenizes Mr / . / Smith) or leading the chunk
    # (raw comparison: _norm strips periods, so "." normalizes to "")
    if prev1 in HONORIFICS or (
        prev and prev[-1] == "." and prev2 in HONORIFICS
    ):
        return "person", True
    if toks[0] in HONORIFICS and len(toks) > 1:
        return "person", True
    # 1b. "Surname, Mr. First Last" (the comma-inverted name shape)
    if next1 == "," and next2 in HONORIFICS:
        return "person", True
    # 2. org suffix / standalone / of-shapes
    if toks[-1] in ORG_SUFFIXES and (len(toks) > 1 or not at_sentence_start):
        return "organization", True
    if any(t in ORG_STANDALONE for t in toks):
        return "organization", True
    if "of" in toks and any(t in _OF_HOSTS for t in toks):
        return "organization", True
    # 3. location gazetteer (whole phrase, else every token)
    if key in LOCATION_PHRASES or key in LOCATIONS:
        return "location", True
    if len(toks) > 1 and all(t in LOCATIONS for t in toks):
        return "location", True
    # 4. given-name gazetteer -> person
    if toks[0] in GIVEN_NAMES:
        return "person", True
    # 5. context cues
    if prev1 in LOCATIVE_PREPS:
        # "in Paris", "from Wakanda" - unknown places ride the preposition
        return "location", True
    if next1 in PERSON_VERBS and len(toks) <= 3:
        return "person", True
    if prev1 in {"with", "by"} and len(toks) == 2:
        return "person", True
    # 6. unmatched: multiword Title-Case defaults to person (the dominant
    #    open class); single tokens are dropped when sentence-initial
    #    with no other evidence (see module docstring)
    if len(toks) >= 2:
        return "person", False
    if not at_sentence_start:
        return None, False  # lone mid-sentence capitals: too weak
    return None, False


def tag_entities(text: Optional[str]) -> dict[str, list[str]]:
    """Tag ``text`` -> {'person': [...], 'location': [...],
    'organization': [...]} with each entity as its normalized chunk
    string (lowercase, order of first appearance, deduplicated)."""
    out: dict[str, list[str]] = {
        "person": [], "location": [], "organization": [],
    }
    if not text:
        return out
    tokens = _TOKEN_RE.findall(text)
    sentence_start = {0}
    for idx, t in enumerate(tokens):
        if t in ".!?":
            sentence_start.add(idx + 1)
    seen = set()
    last_end, last_label = -10, None
    # document-level surname carry (round 5; the OpenNLP models do this
    # implicitly via sentence context): a lone capitalized token with no
    # cue of its own is NOT dropped when an EARLIER (by chunk order)
    # STRONG-evidence multi-token person introduced it as their final
    # token - "Thandiwe Mabaso resigned... Mabaso said" tags both.
    # Restrictions keep the known failure modes out: surname-position
    # only (particles like "van" never carry), strong persons only (a
    # rule-6 default like "Quarterly Report" cannot seed carries), and
    # introduction must PRECEDE the lone mention.
    surname_intro: dict[str, int] = {}  # final token -> intro chunk order
    deferred: list[tuple[int, str]] = []  # (chunk order, token)
    person_order: list[tuple[int, str]] = []  # rebuild in appearance order
    order = 0
    for start, end, chunk in _chunks(tokens):
        label, strong = _classify(
            chunk,
            tokens[max(0, start - 2) : start],
            tokens[end : end + 2],
            at_sentence_start=start in sentence_start and len(chunk) == 1,
        )
        # coordination: "Copenhagen and Malmo" - an unlabeled chunk right
        # after "and"/"," inherits the preceding chunk's label
        if (
            label is None
            and last_label is not None
            and start - last_end == 1
            and tokens[start - 1].lower() in {"and", ","}
        ):
            label = last_label
        order += 1
        if label:
            key = _chunk_key(chunk)
            parts = key.split()
            if parts and parts[0] == "the":
                parts = parts[1:]
            if label == "person":
                while parts and parts[0] in HONORIFICS:
                    parts = parts[1:]
            key = " ".join(parts)
            if key and (label, key) not in seen:
                seen.add((label, key))
                if label == "person":
                    person_order.append((order, key))
                    if strong and len(parts) >= 2:
                        surname_intro.setdefault(parts[-1], order)
                else:
                    out[label].append(key)
        elif len(chunk) == 1:
            deferred.append((order, _norm(chunk[0])))
        last_end, last_label = end, label
    for at, tok in deferred:
        intro = surname_intro.get(tok)
        if (
            intro is not None
            and intro < at  # introduced BEFORE the lone mention
            and ("person", tok) not in seen
            and tok not in HONORIFICS
        ):
            seen.add(("person", tok))
            person_order.append((at, tok))
    out["person"] = [k for _, k in sorted(person_order)]
    return out


def person_name_tokens(text: Optional[str]) -> frozenset:
    """Person-name TOKENS (the NameEntityRecognizer transformer contract:
    a MultiPickList of lowercase name tokens, reference
    OpenNLPNameEntityTagger person tags)."""
    ents = tag_entities(text)
    toks: set[str] = set()
    for name in ents["person"]:
        toks.update(name.split())
    return frozenset(toks)
