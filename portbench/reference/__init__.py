"""Plain reference of the served TTS stack, in float32 PyTorch and NumPy.

It imports nothing of the program under test: every derived quantity
(int8 / int4 weights, the text ids, prompt features, the top-k of the
style DB) is worked out again here from the inputs the benchmark made.
"""
