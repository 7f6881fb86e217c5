"""Typed RPC client stubs — GENERATED, do not edit by hand.

Regenerate with ``python -m ray_tpu_torch.analysis --gen-stubs`` whenever a
handler signature changes; ``make lint`` (rpc-stub-drift) and
``make lint-stubs-check`` fail on drift. Each ``<Owner>Stub`` wraps an
RPC client (RpcClient / ReconnectingClient / anything with ``.call``)
and exposes every handler its server registers as a real method —
method names, arities, and the transport ``timeout`` kwarg are checked
by Python itself instead of failing stringly at the peer.

Parameters the handler defaults are declared ``=_UNSET`` and simply
omitted from the wire when not passed, so the SERVER-side default stays
the single source of truth.
"""

from __future__ import annotations

_UNSET = object()


class _StubBase:
    __slots__ = ("_client",)

    def __init__(self, client):
        self._client = client

    def _call(self, method, *args, timeout=_UNSET, **kwargs):
        kwargs = {k: v for k, v in kwargs.items() if v is not _UNSET}
        if timeout is not _UNSET:
            kwargs["timeout"] = timeout
        return self._client.call(method, *args, **kwargs)


class ClientServerStub(_StubBase):
    """Typed stubs for the ClientServer RPC surface (generated)."""

    def client_actor_call(self, sid, actor_key, method, args_frame,
                          num_returns, *, timeout=_UNSET):
        return self._call('client_actor_call', sid, actor_key, method,
                          args_frame, num_returns, timeout=timeout)

    def client_actor_create(self, sid, cls_blob, args_frame, options, *,
                            timeout=_UNSET):
        return self._call('client_actor_create', sid, cls_blob, args_frame,
                          options, timeout=timeout)

    def client_cluster_resources(self, *, timeout=_UNSET):
        return self._call('client_cluster_resources', timeout=timeout)

    def client_connect(self, *, timeout=_UNSET):
        return self._call('client_connect', timeout=timeout)

    def client_disconnect(self, sid, *, timeout=_UNSET):
        return self._call('client_disconnect', sid, timeout=timeout)

    def client_get(self, *args, timeout=_UNSET, **kwargs):
        return self._call('client_get', *args, timeout=timeout, **kwargs)

    def client_get_actor(self, sid, name, *, timeout=_UNSET):
        return self._call('client_get_actor', sid, name, timeout=timeout)

    def client_kill(self, sid, actor_key, no_restart, *, timeout=_UNSET):
        return self._call('client_kill', sid, actor_key, no_restart,
                          timeout=timeout)

    def client_ping(self, sid, *, timeout=_UNSET):
        return self._call('client_ping', sid, timeout=timeout)

    def client_put(self, sid, frame, *, timeout=_UNSET):
        return self._call('client_put', sid, frame, timeout=timeout)

    def client_release(self, sid, ref_ids, *, timeout=_UNSET):
        return self._call('client_release', sid, ref_ids, timeout=timeout)

    def client_task(self, sid, fn_blob, args_frame, options, *,
                    timeout=_UNSET):
        return self._call('client_task', sid, fn_blob, args_frame, options,
                          timeout=timeout)

    def client_wait(self, *args, timeout=_UNSET, **kwargs):
        return self._call('client_wait', *args, timeout=timeout, **kwargs)

    def ping(self, *args, timeout=_UNSET, **kwargs):
        return self._call('ping', *args, timeout=timeout, **kwargs)


class ControllerStub(_StubBase):
    """Typed stubs for the Controller RPC surface (generated)."""

    def autoscaler_state(self, *, timeout=_UNSET):
        return self._call('autoscaler_state', timeout=timeout)

    def cluster_resources(self, *, timeout=_UNSET):
        return self._call('cluster_resources', timeout=timeout)

    def create_placement_group(self, pg_id_bytes, bundles, strategy, *,
                               timeout=_UNSET):
        return self._call('create_placement_group', pg_id_bytes, bundles,
                          strategy, timeout=timeout)

    def epoch_bump(self, name, *, timeout=_UNSET):
        return self._call('epoch_bump', name, timeout=timeout)

    def finish_job(self, job_id, state=_UNSET, *, timeout=_UNSET):
        return self._call('finish_job', job_id, state=state, timeout=timeout)

    def fr_dump(self, max_age_s=_UNSET, *, timeout=_UNSET):
        return self._call('fr_dump', max_age_s=max_age_s, timeout=timeout)

    def get_actor(self, actor_id_bytes, *, timeout=_UNSET):
        return self._call('get_actor', actor_id_bytes, timeout=timeout)

    def get_named_actor(self, name, *, timeout=_UNSET):
        return self._call('get_named_actor', name, timeout=timeout)

    def get_placement_group(self, pg_id_bytes, *, timeout=_UNSET):
        return self._call('get_placement_group', pg_id_bytes, timeout=timeout)

    def heartbeat(self, node_id_bytes, available, queue_len, seq=_UNSET, *,
                  timeout=_UNSET):
        return self._call('heartbeat', node_id_bytes, available, queue_len,
                          seq=seq, timeout=timeout)

    def kill_actor(self, actor_id_bytes, no_restart=_UNSET, *,
                   timeout=_UNSET):
        return self._call('kill_actor', actor_id_bytes, no_restart=no_restart,
                          timeout=timeout)

    def kv_del(self, key, *, timeout=_UNSET):
        return self._call('kv_del', key, timeout=timeout)

    def kv_get(self, key, *, timeout=_UNSET):
        return self._call('kv_get', key, timeout=timeout)

    def kv_keys(self, prefix=_UNSET, *, timeout=_UNSET):
        return self._call('kv_keys', prefix=prefix, timeout=timeout)

    def kv_put(self, key, value, overwrite=_UNSET, *, timeout=_UNSET):
        return self._call('kv_put', key, value, overwrite=overwrite,
                          timeout=timeout)

    def kv_put_fenced(self, key, value, epoch, epoch_name, *, timeout=_UNSET):
        return self._call('kv_put_fenced', key, value, epoch, epoch_name,
                          timeout=timeout)

    def list_actors(self, *, timeout=_UNSET):
        return self._call('list_actors', timeout=timeout)

    def list_jobs(self, *, timeout=_UNSET):
        return self._call('list_jobs', timeout=timeout)

    def list_metrics(self, *, timeout=_UNSET):
        return self._call('list_metrics', timeout=timeout)

    def list_nodes(self, *, timeout=_UNSET):
        return self._call('list_nodes', timeout=timeout)

    def list_task_events(self, limit=_UNSET, *, timeout=_UNSET):
        return self._call('list_task_events', limit=limit, timeout=timeout)

    def metrics_text(self, *, timeout=_UNSET):
        return self._call('metrics_text', timeout=timeout)

    def mh_barrier(self, group_id, name, member, epoch, payload=_UNSET,
                   timeout_s=_UNSET, *, timeout=_UNSET):
        return self._call('mh_barrier', group_id, name, member, epoch,
                          payload=payload, timeout_s=timeout_s,
                          timeout=timeout)

    def mh_drop_group(self, group_id, *, timeout=_UNSET):
        return self._call('mh_drop_group', group_id, timeout=timeout)

    def mh_group_get(self, group_id, key, *, timeout=_UNSET):
        return self._call('mh_group_get', group_id, key, timeout=timeout)

    def mh_group_put(self, group_id, key, value, epoch, *, timeout=_UNSET):
        return self._call('mh_group_put', group_id, key, value, epoch,
                          timeout=timeout)

    def mh_group_state(self, group_id=_UNSET, *, timeout=_UNSET):
        return self._call('mh_group_state', group_id=group_id,
                          timeout=timeout)

    def mh_member_beat(self, group_id, member, epoch, *, timeout=_UNSET):
        return self._call('mh_member_beat', group_id, member, epoch,
                          timeout=timeout)

    def mh_register_group(self, group_id, num_hosts, reservation_id=_UNSET,
                          owner=_UNSET, *, timeout=_UNSET):
        return self._call('mh_register_group', group_id, num_hosts,
                          reservation_id=reservation_id, owner=owner,
                          timeout=timeout)

    def pick_node(self, resources, strategy=_UNSET, caller_node_id=_UNSET,
                  excluded=_UNSET, *, timeout=_UNSET):
        return self._call('pick_node', resources, strategy=strategy,
                          caller_node_id=caller_node_id, excluded=excluded,
                          timeout=timeout)

    def ping(self, *args, timeout=_UNSET, **kwargs):
        return self._call('ping', *args, timeout=timeout, **kwargs)

    def pipe_drop(self, pipeline_id, *, timeout=_UNSET):
        return self._call('pipe_drop', pipeline_id, timeout=timeout)

    def pipe_register(self, pipeline_id, num_stages, group_id=_UNSET,
                      owner=_UNSET, *, timeout=_UNSET):
        return self._call('pipe_register', pipeline_id, num_stages,
                          group_id=group_id, owner=owner, timeout=timeout)

    def pipe_state(self, pipeline_id=_UNSET, *, timeout=_UNSET):
        return self._call('pipe_state', pipeline_id=pipeline_id,
                          timeout=timeout)

    def pipe_step_complete(self, pipeline_id, step, epoch, *, timeout=_UNSET):
        return self._call('pipe_step_complete', pipeline_id, step, epoch,
                          timeout=timeout)

    def psub_drop(self, channel, key, *, timeout=_UNSET):
        return self._call('psub_drop', channel, key, timeout=timeout)

    def psub_keys(self, channel, *, timeout=_UNSET):
        return self._call('psub_keys', channel, timeout=timeout)

    def psub_poll(self, *args, timeout=_UNSET, **kwargs):
        return self._call('psub_poll', *args, timeout=timeout, **kwargs)

    def psub_poll_many(self, *args, timeout=_UNSET, **kwargs):
        return self._call('psub_poll_many', *args, timeout=timeout, **kwargs)

    def psub_publish(self, channel, key, value, min_version=_UNSET,
                     epoch=_UNSET, *, timeout=_UNSET):
        return self._call('psub_publish', channel, key, value,
                          min_version=min_version, epoch=epoch,
                          timeout=timeout)

    def psub_snapshot(self, channel, *, timeout=_UNSET):
        return self._call('psub_snapshot', channel, timeout=timeout)

    def push_metrics(self, source, snapshot, *, timeout=_UNSET):
        return self._call('push_metrics', source, snapshot, timeout=timeout)

    def push_task_events(self, events, *, timeout=_UNSET):
        return self._call('push_task_events', events, timeout=timeout)

    def register_actor(self, actor_id_bytes, info, spec, opts, *,
                       timeout=_UNSET):
        return self._call('register_actor', actor_id_bytes, info, spec, opts,
                          timeout=timeout)

    def register_job(self, job_id, info, *, timeout=_UNSET):
        return self._call('register_job', job_id, info, timeout=timeout)

    def register_node(self, node_id_bytes, addr, resources, labels,
                      slice_info=_UNSET, *, timeout=_UNSET):
        return self._call('register_node', node_id_bytes, addr, resources,
                          labels, slice_info=slice_info, timeout=timeout)

    def release_subslice(self, reservation_id, *, timeout=_UNSET):
        return self._call('release_subslice', reservation_id, timeout=timeout)

    def remove_placement_group(self, pg_id_bytes, *, timeout=_UNSET):
        return self._call('remove_placement_group', pg_id_bytes,
                          timeout=timeout)

    def report_actor_failure(self, actor_id_bytes, reason=_UNSET, *,
                             timeout=_UNSET):
        return self._call('report_actor_failure', actor_id_bytes,
                          reason=reason, timeout=timeout)

    def report_workers(self, node_id_bytes, started, dead, *, timeout=_UNSET):
        return self._call('report_workers', node_id_bytes, started, dead,
                          timeout=timeout)

    def reserve_subslice(self, owner, chips, shape=_UNSET, *, timeout=_UNSET):
        return self._call('reserve_subslice', owner, chips, shape=shape,
                          timeout=timeout)

    def taint_host(self, node_hex, ttl_s=_UNSET, *, timeout=_UNSET):
        return self._call('taint_host', node_hex, ttl_s=ttl_s,
                          timeout=timeout)

    def taint_state(self, *, timeout=_UNSET):
        return self._call('taint_state', timeout=timeout)

    def topology_state(self, *, timeout=_UNSET):
        return self._call('topology_state', timeout=timeout)

    def unregister_node(self, node_id_bytes, *, timeout=_UNSET):
        return self._call('unregister_node', node_id_bytes, timeout=timeout)

    def untaint_host(self, node_hex, probe=_UNSET, *, timeout=_UNSET):
        return self._call('untaint_host', node_hex, probe=probe,
                          timeout=timeout)


class CoreWorkerStub(_StubBase):
    """Typed stubs for the CoreWorker RPC surface (generated)."""

    def dump_stacks(self, *, timeout=_UNSET):
        return self._call('dump_stacks', timeout=timeout)

    def free_object(self, oid_bytes, *, timeout=_UNSET):
        return self._call('free_object', oid_bytes, timeout=timeout)

    def get_object(self, *args, timeout=_UNSET, **kwargs):
        return self._call('get_object', *args, timeout=timeout, **kwargs)

    def peek_object(self, oid_bytes, *, timeout=_UNSET):
        return self._call('peek_object', oid_bytes, timeout=timeout)

    def ping(self, *args, timeout=_UNSET, **kwargs):
        return self._call('ping', *args, timeout=timeout, **kwargs)

    def profile_cpu(self, duration_s=_UNSET, hz=_UNSET, *, timeout=_UNSET):
        return self._call('profile_cpu', duration_s=duration_s, hz=hz,
                          timeout=timeout)

    def profile_heap(self, top_n=_UNSET, *, timeout=_UNSET):
        return self._call('profile_heap', top_n=top_n, timeout=timeout)

    def profile_heap_stop(self, *, timeout=_UNSET):
        return self._call('profile_heap_stop', timeout=timeout)

    def pull_done(self, oid_bytes, src_key, new_locator, slot_token=_UNSET, *,
                  timeout=_UNSET):
        return self._call('pull_done', oid_bytes, src_key, new_locator,
                          slot_token=slot_token, timeout=timeout)

    def pull_failed(self, oid_bytes, src_key, bad_key, slot_token=_UNSET, *,
                    timeout=_UNSET):
        return self._call('pull_failed', oid_bytes, src_key, bad_key,
                          slot_token=slot_token, timeout=timeout)

    def push_actor_task(self, spec, *, timeout=_UNSET):
        return self._call('push_actor_task', spec, timeout=timeout)

    def push_task(self, spec, *, timeout=_UNSET):
        return self._call('push_task', spec, timeout=timeout)

    def push_task_batch(self, specs, *, timeout=_UNSET):
        return self._call('push_task_batch', specs, timeout=timeout)

    def reconstruct_object(self, oid_bytes, *, timeout=_UNSET):
        return self._call('reconstruct_object', oid_bytes, timeout=timeout)

    def ref_update(self, deltas, sender=_UNSET, *, timeout=_UNSET):
        return self._call('ref_update', deltas, sender=sender,
                          timeout=timeout)

    def shutdown_worker(self, *, timeout=_UNSET):
        return self._call('shutdown_worker', timeout=timeout)

    def start_actor(self, spec, *, timeout=_UNSET):
        return self._call('start_actor', spec, timeout=timeout)

    def stream_item(self, task_id, index, packed, *, timeout=_UNSET):
        return self._call('stream_item', task_id, index, packed,
                          timeout=timeout)

    def wait_object(self, *args, timeout=_UNSET, **kwargs):
        return self._call('wait_object', *args, timeout=timeout, **kwargs)


class NodeStub(_StubBase):
    """Typed stubs for the Node RPC surface (generated)."""

    def create_actor_worker(self, *args, timeout=_UNSET, **kwargs):
        return self._call('create_actor_worker', *args, timeout=timeout,
                          **kwargs)

    def free_shm_object(self, oid_bytes, *, timeout=_UNSET):
        return self._call('free_shm_object', oid_bytes, timeout=timeout)

    def get_info(self, *, timeout=_UNSET):
        return self._call('get_info', timeout=timeout)

    def kill_worker(self, worker_id_bytes, force=_UNSET, reason=_UNSET, *,
                    timeout=_UNSET):
        return self._call('kill_worker', worker_id_bytes, force=force,
                          reason=reason, timeout=timeout)

    def lease_worker(self, *args, timeout=_UNSET, **kwargs):
        return self._call('lease_worker', *args, timeout=timeout, **kwargs)

    def list_workers(self, *, timeout=_UNSET):
        return self._call('list_workers', timeout=timeout)

    def ping(self, *args, timeout=_UNSET, **kwargs):
        return self._call('ping', *args, timeout=timeout, **kwargs)

    def prestart_workers(self, count, *, timeout=_UNSET):
        return self._call('prestart_workers', count, timeout=timeout)

    def read_shm_chunk(self, oid_bytes, offset, length, *, timeout=_UNSET):
        return self._call('read_shm_chunk', oid_bytes, offset, length,
                          timeout=timeout)

    def read_shm_object(self, oid_bytes, *, timeout=_UNSET):
        return self._call('read_shm_object', oid_bytes, timeout=timeout)

    def register_worker(self, worker_id_bytes, addr, pid=_UNSET, *,
                        timeout=_UNSET):
        return self._call('register_worker', worker_id_bytes, addr, pid=pid,
                          timeout=timeout)

    def release_bundle(self, pg_id, index, *, timeout=_UNSET):
        return self._call('release_bundle', pg_id, index, timeout=timeout)

    def reserve_bundle(self, pg_id, index, resources, *, timeout=_UNSET):
        return self._call('reserve_bundle', pg_id, index, resources,
                          timeout=timeout)

    def return_worker(self, worker_id_bytes, resources, bundle=_UNSET,
                      dead=_UNSET, lease_seq=_UNSET, *, timeout=_UNSET):
        return self._call('return_worker', worker_id_bytes, resources,
                          bundle=bundle, dead=dead, lease_seq=lease_seq,
                          timeout=timeout)

    def validate_lease(self, worker_id_bytes, lease_seq, *, timeout=_UNSET):
        return self._call('validate_lease', worker_id_bytes, lease_seq,
                          timeout=timeout)

    def worker_death_cause(self, worker_id_bytes, *, timeout=_UNSET):
        return self._call('worker_death_cause', worker_id_bytes,
                          timeout=timeout)

    def worker_ping(self, worker_id_bytes, tasks_received=_UNSET,
                    active_tasks=_UNSET, actor_started=_UNSET, *,
                    timeout=_UNSET):
        return self._call('worker_ping', worker_id_bytes,
                          tasks_received=tasks_received,
                          active_tasks=active_tasks,
                          actor_started=actor_started, timeout=timeout)
