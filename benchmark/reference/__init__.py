"""The plain reference that decides ``correct``: plain PyTorch, written
from the algorithms' definitions. It imports nothing of the program and
takes nothing the program built: it works out its own message lists and
neighbours from the benchmark's inputs."""
