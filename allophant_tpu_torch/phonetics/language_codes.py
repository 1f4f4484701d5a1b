"""ISO-639 language-code normalization with embedded tables.

The port's copy of ``allophant_tpu/phonetics/language_codes.py``.

Behavioral counterpart of the reference's allophant/language_codes.py, which delegates
to the ``langcodes`` package (not available in this environment). The embedded tables
cover ISO 639-1 ↔ 639-3 (terminological and bibliographic forms) plus the
macrolanguage memberships relevant to speech corpora (Common Voice, UCLA Phonetic
Corpus, PHOIBLE). Unknown 3-letter codes pass through unchanged, matching how
``langcodes`` treats valid-but-unmapped codes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, Union

# ISO 639-1 (alpha-2) -> ISO 639-3 terminological (T) code.
ISO6391_TO_3: Dict[str, str] = {
    "aa": "aar", "ab": "abk", "ae": "ave", "af": "afr", "ak": "aka", "am": "amh",
    "an": "arg", "ar": "ara", "as": "asm", "av": "ava", "ay": "aym", "az": "aze",
    "ba": "bak", "be": "bel", "bg": "bul", "bi": "bis", "bm": "bam", "bn": "ben",
    "bo": "bod", "br": "bre", "bs": "bos", "ca": "cat", "ce": "che", "ch": "cha",
    "co": "cos", "cr": "cre", "cs": "ces", "cu": "chu", "cv": "chv", "cy": "cym",
    "da": "dan", "de": "deu", "dv": "div", "dz": "dzo", "ee": "ewe", "el": "ell",
    "en": "eng", "eo": "epo", "es": "spa", "et": "est", "eu": "eus", "fa": "fas",
    "ff": "ful", "fi": "fin", "fj": "fij", "fo": "fao", "fr": "fra", "fy": "fry",
    "ga": "gle", "gd": "gla", "gl": "glg", "gn": "grn", "gu": "guj", "gv": "glv",
    "ha": "hau", "he": "heb", "hi": "hin", "ho": "hmo", "hr": "hrv", "ht": "hat",
    "hu": "hun", "hy": "hye", "hz": "her", "ia": "ina", "id": "ind", "ie": "ile",
    "ig": "ibo", "ii": "iii", "ik": "ipk", "io": "ido", "is": "isl", "it": "ita",
    "iu": "iku", "ja": "jpn", "jv": "jav", "ka": "kat", "kg": "kon", "ki": "kik",
    "kj": "kua", "kk": "kaz", "kl": "kal", "km": "khm", "kn": "kan", "ko": "kor",
    "kr": "kau", "ks": "kas", "ku": "kur", "kv": "kom", "kw": "cor", "ky": "kir",
    "la": "lat", "lb": "ltz", "lg": "lug", "li": "lim", "ln": "lin", "lo": "lao",
    "lt": "lit", "lu": "lub", "lv": "lav", "mg": "mlg", "mh": "mah", "mi": "mri",
    "mk": "mkd", "ml": "mal", "mn": "mon", "mr": "mar", "ms": "msa", "mt": "mlt",
    "my": "mya", "na": "nau", "nb": "nob", "nd": "nde", "ne": "nep", "ng": "ndo",
    "nl": "nld", "nn": "nno", "no": "nor", "nr": "nbl", "nv": "nav", "ny": "nya",
    "oc": "oci", "oj": "oji", "om": "orm", "or": "ori", "os": "oss", "pa": "pan",
    "pi": "pli", "pl": "pol", "ps": "pus", "pt": "por", "qu": "que", "rm": "roh",
    "rn": "run", "ro": "ron", "ru": "rus", "rw": "kin", "sa": "san", "sc": "srd",
    "sd": "snd", "se": "sme", "sg": "sag", "si": "sin", "sk": "slk", "sl": "slv",
    "sm": "smo", "sn": "sna", "so": "som", "sq": "sqi", "sr": "srp", "ss": "ssw",
    "st": "sot", "su": "sun", "sv": "swe", "sw": "swa", "ta": "tam", "te": "tel",
    "tg": "tgk", "th": "tha", "ti": "tir", "tk": "tuk", "tl": "tgl", "tn": "tsn",
    "to": "ton", "tr": "tur", "ts": "tso", "tt": "tat", "tw": "twi", "ty": "tah",
    "ug": "uig", "uk": "ukr", "ur": "urd", "uz": "uzb", "ve": "ven", "vi": "vie",
    "vo": "vol", "wa": "wln", "wo": "wol", "xh": "xho", "yi": "yid", "yo": "yor",
    "za": "zha", "zh": "zho", "zu": "zul",
}

ISO6393_TO_1: Dict[str, str] = {three: two for two, three in ISO6391_TO_3.items()}

# Bibliographic (B) -> terminological (T) 639-2 codes where they differ.
ALPHA3_B_TO_T: Dict[str, str] = {
    "alb": "sqi", "arm": "hye", "baq": "eus", "bur": "mya", "chi": "zho",
    "cze": "ces", "dut": "nld", "fre": "fra", "geo": "kat", "ger": "deu",
    "gre": "ell", "ice": "isl", "mac": "mkd", "may": "msa", "mao": "mri",
    "per": "fas", "rum": "ron", "slo": "slk", "tib": "bod", "wel": "cym",
}
ALPHA3_T_TO_B: Dict[str, str] = {t: b for b, t in ALPHA3_B_TO_T.items()}

# ISO 639-3 individual language -> macrolanguage (subset covering speech corpora).
MACRO_OF: Dict[str, str] = {
    # Azerbaijani
    "azj": "aze", "azb": "aze",
    # Arabic
    "arb": "ara", "arz": "ara", "apc": "ara", "acm": "ara", "afb": "ara",
    "ajp": "ara", "apd": "ara", "ary": "ara", "aeb": "ara", "acw": "ara",
    "ayl": "ara", "aao": "ara", "abh": "ara", "abv": "ara", "acq": "ara",
    "acx": "ara", "adf": "ara", "aec": "ara", "arq": "ara", "ars": "ara",
    "auz": "ara", "avl": "ara", "ayh": "ara", "ayn": "ara", "ayp": "ara",
    "shu": "ara", "ssh": "ara",
    # Chinese
    "cmn": "zho", "yue": "zho", "wuu": "zho", "hak": "zho", "nan": "zho",
    "gan": "zho", "hsn": "zho", "cjy": "zho", "czh": "zho", "cdo": "zho",
    "mnp": "zho", "cpx": "zho", "czo": "zho", "lzh": "zho", "cnp": "zho",
    "csp": "zho",
    # Estonian / Latvian
    "ekk": "est", "vro": "est", "lvs": "lav", "ltg": "lav",
    # Persian
    "pes": "fas", "prs": "fas",
    # Fulah
    "fuv": "ful", "fub": "ful", "ffm": "ful", "fuc": "ful", "fuf": "ful",
    "fue": "ful", "fuh": "ful", "fui": "ful", "fuq": "ful", "fuy": "ful",
    # Guarani / Aymara
    "gug": "grn", "gun": "grn", "gui": "grn", "gnw": "grn", "nhd": "grn",
    "ayr": "aym", "ayc": "aym",
    # Inuktitut
    "ike": "iku", "ikt": "iku",
    # Kurdish
    "kmr": "kur", "ckb": "kur", "sdh": "kur",
    # Malagasy
    "plt": "mlg", "bhr": "mlg", "skg": "mlg", "tdx": "mlg", "txy": "mlg",
    "xmv": "mlg", "xmw": "mlg", "msh": "mlg", "bmm": "mlg", "bzc": "mlg",
    # Mongolian
    "khk": "mon", "mvf": "mon",
    # Malay
    "zsm": "msa", "zlm": "msa", "min": "msa", "bjn": "msa", "jax": "msa",
    # Nepali / Oriya / Oromo
    "npi": "nep", "dty": "nep", "ory": "ori", "spv": "ori",
    "gaz": "orm", "gax": "orm", "hae": "orm", "orc": "orm",
    # Norwegian
    "nob": "nor", "nno": "nor",
    # Pashto
    "pbt": "pus", "pbu": "pus", "pst": "pus",
    # Quechua
    "quy": "que", "quz": "que", "qub": "que", "quh": "que", "qul": "que",
    "qus": "que", "quw": "que", "qux": "que", "qug": "que", "qvc": "que",
    "qve": "que", "qvh": "que", "qvi": "que", "qvm": "que", "qvn": "que",
    "qvs": "que", "qvw": "que", "qvz": "que", "qwa": "que", "qwc": "que",
    "qwh": "que", "qws": "que", "qxa": "que", "qxc": "que", "qxh": "que",
    "qxl": "que", "qxn": "que", "qxo": "que", "qxp": "que", "qxr": "que",
    "qxt": "que", "qxu": "que", "qxw": "que", "qud": "que", "quf": "que",
    "qug": "que", "quk": "que", "qup": "que", "qur": "que",
    # Albanian / Sardinian / Swahili
    "als": "sqi", "aae": "sqi", "aat": "sqi", "aln": "sqi",
    "src": "srd", "sro": "srd", "sdc": "srd", "sdn": "srd",
    "swh": "swa", "swc": "swa",
    # Uzbek / Yiddish / Akan / Kanuri
    "uzn": "uzb", "uzs": "uzb", "ydd": "yid", "yih": "yid",
    "twi": "aka", "fat": "aka", "knc": "kau", "kby": "kau", "krt": "kau",
    # Konkani / Komi / Dogri / Baluchi / Zaza
    "knn": "kok", "gom": "kok", "kpv": "kom", "koi": "kom",
    "dgo": "doi", "xnr": "doi", "bgp": "bal", "bgn": "bal", "bcc": "bal",
    "kiu": "zza", "diq": "zza",
}


def _normalize_language_subtag(subtag: str, macro: bool = False) -> str:
    """Normalizes a bare language subtag to its preferred form (2-letter if one
    exists, otherwise the 639-3 T code)."""
    code = subtag.lower()
    if len(code) == 3:
        code = ALPHA3_B_TO_T.get(code, code)
        if macro:
            code = MACRO_OF.get(code, code)
        return ISO6393_TO_1.get(code, code)
    return code


def standardize_tag(tag: str, macro: bool = False) -> str:
    """BCP-47-style normalization: preferred language subtag casing + territory upper.

    Mirrors the subset of ``langcodes.standardize_tag`` behavior the reference relies
    on (2-letter preference, optional macrolanguage replacement, territory retained).
    """
    parts = str(tag).replace("_", "-").split("-")
    language = _normalize_language_subtag(parts[0], macro)
    rest = []
    for part in parts[1:]:
        if len(part) == 2 and part.isalpha():
            rest.append(part.upper())
        elif len(part) == 4 and part.isalpha():
            rest.append(part.title())
        else:
            rest.append(part)
    return "-".join([language, *rest])


@dataclass
class LanguageCode:
    language: str
    alpha3_t: str
    alpha3_b: str
    variant: str | None

    @classmethod
    def from_str(cls, language_code: str, standardize: bool = False, macro: bool = False):
        if standardize:
            language_code = standardize_tag(language_code, macro=macro)
        elif macro:
            raise ValueError("Retrieving the macro language requires standardization")

        parts = str(language_code).replace("_", "-").split("-")
        language = parts[0].lower()
        if not (2 <= len(language) <= 3 and language.isalpha()):
            raise ValueError(f"{language_code!r} does not contain a valid language code")
        variants = [part for part in parts[1:] if part]

        if len(language) == 2:
            alpha3_t = ISO6391_TO_3.get(language, language)
        else:
            alpha3_t = ALPHA3_B_TO_T.get(language, language)
        alpha3_b = ALPHA3_T_TO_B.get(alpha3_t, alpha3_t)

        return cls(language, alpha3_t, alpha3_b, "-".join(variants) if variants else None)

    @property
    def alpha3(self) -> str:
        return self.alpha3_t

    def __str__(self) -> str:
        return self.language if self.variant is None else f"{self.language}-{self.variant}"


def standardize_to_iso6393(language_code: str) -> str:
    return LanguageCode.from_str(language_code, True).alpha3


LanguageCodeAny = Union[str, LanguageCode]


def to_language_code(language_code: LanguageCodeAny) -> LanguageCode:
    if isinstance(language_code, str):
        return LanguageCode.from_str(language_code)
    return language_code


class LanguageCodeMap:
    """Resolves user-supplied language codes to the codes a corpus was built with,
    handling regional variants and per-language defaults (reference:
    the reference's allophant/language_codes.py:69-129)."""

    def __init__(self, language_codes: Iterable[str], defaults: Dict[str, str] | None = None) -> None:
        if defaults is None:
            defaults = {}
        code_map: Dict[str, str] = {}
        existing_codes: Dict[str, tuple] = {}
        duplicates = set()
        has_default = set()

        for code in language_codes:
            standardized = standardize_tag(code, macro=True)
            language_code = LanguageCode.from_str(code)
            language = language_code.language
            code_map[standardized] = code

            if language_code.variant is None:
                existing_codes[language] = (code, language_code)
                has_default.add(language)
            elif language in existing_codes:
                duplicates.add(language)
                code_map[str(language_code)] = code
            else:
                existing_codes[language] = (code, language_code)

        for code, language_code in existing_codes.values():
            language = language_code.language
            if language not in has_default and (default_variant := defaults.get(language)) is not None:
                code_map[language] = default_variant
                has_default.add(code)
            if language in duplicates:
                code_map[str(language_code)] = code
            else:
                code_map[language] = code

        self._code_map = code_map

    def __repr__(self) -> str:
        return f"{self.__class__.__name__}({self._code_map})"

    def __getitem__(self, code: LanguageCodeAny) -> str:
        standardized = standardize_tag(str(code))
        return self._code_map.get(standardized) or self._code_map[LanguageCode.from_str(standardized).language]

    def __contains__(self, code: LanguageCodeAny) -> bool:
        standardized = standardize_tag(str(code))
        return standardized in self._code_map or LanguageCode.from_str(standardized).language in self._code_map

    def __len__(self) -> int:
        return len(self._code_map)
