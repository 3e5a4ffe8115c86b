"""Training: the loss, the optimiser and the train step (port of the JAX
package's ``training/``)."""
