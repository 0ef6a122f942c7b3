"""The 99 Whisper languages (V1 token set, no Cantonese).

Mirror of the reference's ``src/models/whisper/languages.rs`` (a copy of
``norma_tpu/models/whisper/languages.py``).  CRITICAL:
the declaration order equals Whisper's language-token ordering — language
detection indexes the model's language-token logits positionally
(reference: model.rs:204), so this list must never be re-ordered.
"""

from __future__ import annotations

import enum


class Language(enum.Enum):
    ENGLISH = "en"
    CHINESE = "zh"
    GERMAN = "de"
    SPANISH = "es"
    RUSSIAN = "ru"
    KOREAN = "ko"
    FRENCH = "fr"
    JAPANESE = "ja"
    PORTUGUESE = "pt"
    TURKISH = "tr"
    POLISH = "pl"
    CATALAN = "ca"
    DUTCH = "nl"
    ARABIC = "ar"
    SWEDISH = "sv"
    ITALIAN = "it"
    INDONESIAN = "id"
    HINDI = "hi"
    FINNISH = "fi"
    VIETNAMESE = "vi"
    HEBREW = "he"
    UKRAINIAN = "uk"
    GREEK = "el"
    MALAY = "ms"
    CZECH = "cs"
    ROMANIAN = "ro"
    DANISH = "da"
    HUNGARIAN = "hu"
    TAMIL = "ta"
    NORWEGIAN = "no"
    THAI = "th"
    URDU = "ur"
    CROATIAN = "hr"
    BULGARIAN = "bg"
    LITHUANIAN = "lt"
    LATIN = "la"
    MAORI = "mi"
    MALAYALAM = "ml"
    WELSH = "cy"
    SLOVAK = "sk"
    TELUGU = "te"
    PERSIAN = "fa"
    LATVIAN = "lv"
    BENGALI = "bn"
    SERBIAN = "sr"
    AZERBAIJANI = "az"
    SLOVENIAN = "sl"
    KANNADA = "kn"
    ESTONIAN = "et"
    MACEDONIAN = "mk"
    BRETON = "br"
    BASQUE = "eu"
    ICELANDIC = "is"
    ARMENIAN = "hy"
    NEPALI = "ne"
    MONGOLIAN = "mn"
    BOSNIAN = "bs"
    KAZAKH = "kk"
    ALBANIAN = "sq"
    SWAHILI = "sw"
    GALICIAN = "gl"
    MARATHI = "mr"
    PUNJABI = "pa"
    SINHALA = "si"
    KHMER = "km"
    SHONA = "sn"
    YORUBA = "yo"
    SOMALI = "so"
    AFRIKAANS = "af"
    OCCITAN = "oc"
    GEORGIAN = "ka"
    BELARUSIAN = "be"
    TAJIK = "tg"
    SINDHI = "sd"
    GUJARATI = "gu"
    AMHARIC = "am"
    YIDDISH = "yi"
    LAO = "lo"
    UZBEK = "uz"
    FAROESE = "fo"
    HAITIAN_CREOLE = "ht"
    PASHTO = "ps"
    TURKMEN = "tk"
    NYNORSK = "nn"
    MALTESE = "mt"
    SANSKRIT = "sa"
    LUXEMBOURGISH = "lb"
    MYANMAR = "my"
    TIBETAN = "bo"
    TAGALOG = "tl"
    MALAGASY = "mg"
    ASSAMESE = "as"
    TATAR = "tt"
    HAWAIIAN = "haw"
    LINGALA = "ln"
    HAUSA = "ha"
    BASHKIR = "ba"
    JAVANESE = "jw"
    SUNDANESE = "su"

    @property
    def code(self) -> str:
        return self.value

    def token(self) -> str:
        """The language token string, e.g. '<|en|>' (languages.rs:112-118)."""
        return f"<|{self.value}|>"

    def __str__(self) -> str:  # display name, e.g. "Haitian Creole"
        return self.name.replace("_", " ").title()


# Positional list in Whisper token order (used by language detection).
ALL_LANGUAGES = list(Language)
assert len(ALL_LANGUAGES) == 99
