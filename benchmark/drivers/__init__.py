"""Traffic drivers, one per kind of entry into the program; a mix file names its driver."""
