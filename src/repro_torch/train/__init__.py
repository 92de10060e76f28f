"""LM-scale bilevel training: the loss, the INTERACT and SVR-INTERACT
train steps across a process group."""
