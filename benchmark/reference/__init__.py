"""The plain reference: float32 PyTorch, written from the published
architectures, importing nothing of the program under test."""
