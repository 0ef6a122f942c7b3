from .engine import DecodeEngine, DecodingResult
from .longform import LanguageState, LongFormDecoder
from .masks import Masks, SpecialTokens, build_masks
from .speculative import SpeculativeEngine

__all__ = [
    "DecodeEngine",
    "DecodingResult",
    "LanguageState",
    "LongFormDecoder",
    "Masks",
    "SpecialTokens",
    "SpeculativeEngine",
    "build_masks",
]
