"""The plain reference: float32 PyTorch towers, tokenisation, search and
training step, written from the published models. It imports nothing of
the program under test."""
