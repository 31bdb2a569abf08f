"""The system's core: tier placement, and the int8 compression model."""
