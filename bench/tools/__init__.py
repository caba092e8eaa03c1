"""Tools of the benchmark: the control and the planted faults, the knee sweep."""
