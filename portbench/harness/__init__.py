"""The benchmark's yardstick: how cells, configurations, mixes, metrics and
limits are found by name, the card's peaks, the closed-loop window, the
reduction of a profiler trace, and the output line."""
