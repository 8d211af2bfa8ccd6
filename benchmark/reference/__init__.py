"""The plain reference that decides ``correct``: plain PyTorch and numpy,
importing nothing of the program. ``slam/`` holds frozen copies of the
plain versions of the modules the timed paths run (see its package
docstring); the modules beside it drive them as each cell's entry does."""
