"""CNN workloads of the port: layers, ResNet models, deployment graphs and
the graph executor."""
