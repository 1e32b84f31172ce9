"""The plain reference: the decoder's equations in fp32 PyTorch, with
nothing of the program under test."""
