"""The benchmark's yardstick: the card's peaks and the operation and byte
counts of the served window."""
