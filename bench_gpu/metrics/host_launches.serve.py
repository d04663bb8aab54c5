"""host_launches.serve: the host's CUDA runtime calls that put work on the
card a frame in the profile: kernel and graph launches, async copies and
memsets."""


def read(t):
    return t.host_launches
