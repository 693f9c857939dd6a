"""One module per architecture a configuration names (``arch``): its table
of the forward's work, its weights drawn from the seed in the port's
layout, and the call into ``repro_torch`` that the window drives."""
