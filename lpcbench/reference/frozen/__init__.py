"""A frozen copy of the port's plain PyTorch modules that the reference
builds on: the DSP tables and mu-law, the activations, the feature
extractor, Burg's analysis, the layers, the LPCNet frame network and the
PLC network. They are copied as they were, imports relative to this
package, so that the yardstick does not move when the program does. Only
the reference imports them; the program never does."""
