from .batching import BatchedStreamHandle, BatchedTranscriber, TooManyStreams
from .channels import Chunk, ReceiverClosed, RecycledRing, StringChannel, StringReceiver

__all__ = [
    "BatchedStreamHandle",
    "BatchedTranscriber",
    "Chunk",
    "ReceiverClosed",
    "RecycledRing",
    "StringChannel",
    "StringReceiver",
    "TooManyStreams",
]
