from .wer import WerResult, edit_distance, normalize_text, word_error_rate

__all__ = ["WerResult", "edit_distance", "normalize_text", "word_error_rate"]
