"""Grad engines beyond autograd (port of picotron_tpu/parallel/, single
device so far: the parallel layouts are ROADMAP Queue 1 item 9)."""
