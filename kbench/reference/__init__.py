"""Plain references, one module per kind of configuration (a
configuration's ``reference`` names its module).  They import torch
alone: nothing of the program, nor JAX."""
