"""The measurement scripts of the JAX package's `scripts/`, ported: each keeps
its counterpart's name, constants, arguments and printed lines, adds
`--device` (the card unless named) and runs as
`python -m cuvs_rag_tpu_torch.scripts.<name>`. Each has `run(args,
hold=None)`: a script with an exact search among its A/Bs calls
hold(name, corpus, queries, distances, ids) on it; the others never do.
`common` holds what several of them repeat."""
