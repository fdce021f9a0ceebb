"""One rank of a real four-rank mesh: the worker of
``tests/test_torch_mesh.py``'s split-mesh cases.

``run(rank, world, init_method, cases_path, out_path)`` joins a gloo group
of ``world`` ranks (a file store: no port), builds the (2, 2) ("data",
"model") mesh on it, and for each case in ``cases_path`` (a
``torch.save``'d dict: case -> (arch, shape name, spec fields, cfg fields,
state, inputs)) places the state and inputs by the spec's
``state_shardings`` / ``input_shardings``, runs ``make_step(shape,
axes_of(mesh))`` and gathers every output leaf whole.  Rank 0 saves the
gathered (state, outputs) per case to ``out_path``.
"""
import dataclasses

import torch


def spec_of(arch, spec_kw, cfg_kw):
    from repro_torch.configs import all_archs

    t = all_archs()[arch].reduced()
    if cfg_kw:
        t = dataclasses.replace(t, cfg=dataclasses.replace(t.cfg, **cfg_kw))
    return dataclasses.replace(t, **spec_kw)


def run(rank, world, init_method, cases_path, out_path):
    import torch.distributed as dist

    from repro_torch.configs import axes_of
    from repro_torch.launch import mesh as tmesh
    from repro_torch.models.layers import is_dtensor
    from repro_torch.training.optimizer import tree_map

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init_method, rank=rank,
                            world_size=world)
    try:
        mesh = tmesh.make_mesh((2, world // 2), ("data", "model"))
        axes = axes_of(mesh)
        cases = torch.load(cases_path, weights_only=False)
        got = {}
        for case, (arch, shape_name, spec_kw, cfg_kw, state,
                   inputs) in cases.items():
            t = spec_of(arch, spec_kw, cfg_kw)
            shape = t.shapes()[shape_name]
            m_state = tmesh.place(state, t.state_shardings(shape, axes),
                                  mesh)
            m_inputs = tmesh.place(inputs, t.input_shardings(shape, axes),
                                   mesh)
            out = t.make_step(shape, axes)(m_state, m_inputs)
            got[case] = tree_map(
                lambda x: x.full_tensor() if is_dtensor(x) else x, out)
        if rank == 0:
            torch.save(got, out_path)
    finally:
        dist.destroy_process_group()
