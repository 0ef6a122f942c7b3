"""The plain reference the benchmark holds the program to: float32 Whisper
in plain torch (``whisper_ref.py``) and the served greedy grammar
(``grammar.py``).  Nothing here imports the program."""
