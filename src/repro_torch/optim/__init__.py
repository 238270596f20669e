"""Optimizer of the port: AdamW with the cosine schedule and global-norm
clip, and int8 error-feedback gradient compression."""
