from .engine import DecodeEngine, DecodingResult
from .longform import LanguageState, LongFormDecoder
from .masks import Masks, SpecialTokens, build_masks

__all__ = [
    "DecodeEngine",
    "DecodingResult",
    "LanguageState",
    "LongFormDecoder",
    "Masks",
    "SpecialTokens",
    "build_masks",
]
