"""End-to-end programs: the fused frame→identity path."""
