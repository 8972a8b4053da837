"""The plain reference: one module per family (``<family>.py``), each with
``forward(ar, params, tokens, r) -> logits``, and the AsGrad round
(``asgrad.py``).  Float32 with TF32 off; it imports nothing of the
program and is handed only the benchmark's own weights and inputs."""
