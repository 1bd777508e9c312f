"""The plain reference the benchmark holds the program to: the compiled
chain, Philox4x32-10 and the program's counter layout, the six-phase step,
the tanh-Gaussian actor-critic, GAE, the PPO loss, the clip and Adam, in
plain PyTorch.  It imports nothing of the program."""
