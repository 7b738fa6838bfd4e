"""The yardstick: plain references of what the program computes, the
operation and byte counts behind every roofline share, and the card's
peaks. Nothing here imports the program, JAX or the JAX package."""
