"""The benchmark's own yardstick: finding cells by name, traffic and data
made from the seed, weights, statistics over the window, the profiler's
trace reduced to device time, and the peaks and operation counts."""
