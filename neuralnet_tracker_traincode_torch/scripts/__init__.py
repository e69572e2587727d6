"""The command-line entry points of the port, each run as
`python -m neuralnet_tracker_traincode_torch.scripts.<name>`, with the JAX
package's scripts' flags and defaults and `--device` (default `cuda`)."""
