"""Launch tooling of the port: device meshes, the dry run on a fake
process group, and the roofline over its artifacts."""
