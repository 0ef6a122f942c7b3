from .batching import BatchedStreamHandle, BatchedTranscriber, TooManyStreams
from .channels import Chunk, ReceiverClosed, RecycledRing, StringChannel, StringReceiver
from .transcriber import JoinHandle, Transcriber, TranscriberHandle

__all__ = [
    "BatchedStreamHandle",
    "BatchedTranscriber",
    "Chunk",
    "JoinHandle",
    "ReceiverClosed",
    "RecycledRing",
    "StringChannel",
    "StringReceiver",
    "TooManyStreams",
    "Transcriber",
    "TranscriberHandle",
]
