"""The benchmark's yardstick: the H100's peaks, the operations and bytes of
the port's kernel calls, and each model family's counts, from shapes alone."""
