"""Plain references of the benchmark's model families: torch functionals on a
dict of weights, importing nothing of the program.  ``<family>.build(p, model,
rewrites, calib, bits)`` returns the forward of the model a recipe serves."""
