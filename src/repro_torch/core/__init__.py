"""The system's core: tier placement, offload, and int8 compression."""
