"""The benchmark's plain reference: a frozen copy of the PyTorch port's
plain path (its modules keep the port's names and docstrings), with every
hand-written kernel's dispatch taken out: the structured linearization
for K1, the sequential Riccati sweep for K2+K3 and ``node_eval`` for K4.
It imports nothing of the program and is never edited with it: a check
compares the program with this copy.

``frontend``, ``solve`` and ``replan`` drive it as each kind of cell
needs.  Each takes the
configuration's dtype as ``reg_dtype``: the Riccati sweep's regularisation
(100 eps of that dtype) is part of the problem the configuration states,
whatever precision computes it.
"""
