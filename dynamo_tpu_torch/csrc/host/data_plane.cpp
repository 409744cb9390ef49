// Native data-plane stream sender: two-part frame writer + control-frame
// reader on one socket, driven by a dedicated poll thread.
//
// A copy of the JAX package's csrc/data_plane.cpp, built for the port by
// dynamo_tpu_torch/utils/native.py (a host library with -pthread) and bound
// by dynamo_tpu_torch/runtime/native_tcp.py. It is the response-plane egress
// of the reference (lib/runtime/src/pipeline/network/tcp/{server,client}.rs
// + codec/two_part.rs): the worker dials the caller back and streams
// length-prefixed frames while watching for STOP/KILL control frames from
// the receiver. The framing and socket writes run off the Python event
// loop; control state surfaces as atomic flags the engine polls at step
// granularity.
//
// Three producers ride this plane: per-token response streams
// (runtime/ingress.py), the disaggregated KV wire (llm/disagg.py) and the
// KV fabric's block fetches (llm/kv/fabric.py "fetch_native": one frame per
// KV block, npz bytes in the data part, the hash in the header part).
//
// Frame layout (big-endian): [kind u8][header_len u32][data_len u32][header][data]

#include <arpa/inet.h>
#include <errno.h>
#include <fcntl.h>
#include <netdb.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <poll.h>
#include <string.h>
#include <sys/eventfd.h>
#include <sys/socket.h>
#include <unistd.h>

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr uint8_t KIND_STOP = 3;
constexpr uint8_t KIND_KILL = 4;
constexpr uint32_t CTRL_STOP = 1;
constexpr uint32_t CTRL_KILL = 2;
constexpr uint32_t CTRL_PEER_CLOSED = 4;
constexpr size_t READ_CHUNK = 16 * 1024;

struct Sender {
    int fd = -1;
    int evfd = -1;
    std::thread th;
    std::mutex mu;
    std::condition_variable drained;
    std::deque<std::string> queue;   // pre-framed byte strings
    size_t queued_bytes = 0;
    bool closing = false;
    std::atomic<int> err{0};
    std::atomic<uint32_t> ctrl{0};
    // control-frame parse state
    std::string rbuf;

    void wake() {
        uint64_t one = 1;
        ssize_t n = write(evfd, &one, sizeof(one));
        (void)n;
    }

    void parse_control() {
        // consume complete frames from rbuf; only the kind matters
        while (rbuf.size() >= 9) {
            const uint8_t* b = reinterpret_cast<const uint8_t*>(rbuf.data());
            uint8_t kind = b[0];
            uint32_t hlen = (uint32_t(b[1]) << 24) | (uint32_t(b[2]) << 16) |
                            (uint32_t(b[3]) << 8) | uint32_t(b[4]);
            uint32_t dlen = (uint32_t(b[5]) << 24) | (uint32_t(b[6]) << 16) |
                            (uint32_t(b[7]) << 8) | uint32_t(b[8]);
            size_t total = 9 + size_t(hlen) + size_t(dlen);
            if (rbuf.size() < total) return;
            if (kind == KIND_STOP) ctrl.fetch_or(CTRL_STOP);
            if (kind == KIND_KILL) ctrl.fetch_or(CTRL_KILL);
            rbuf.erase(0, total);
        }
    }

    void run() {
        std::vector<char> chunk(READ_CHUNK);
        while (true) {
            bool have_data;
            {
                std::lock_guard<std::mutex> lk(mu);
                have_data = !queue.empty();
                if (queue.empty() && closing) break;
            }
            struct pollfd fds[2];
            fds[0] = {fd, static_cast<short>(POLLIN | (have_data ? POLLOUT : 0)), 0};
            fds[1] = {evfd, POLLIN, 0};
            int rc = poll(fds, 2, 1000);
            if (rc < 0) {
                if (errno == EINTR) continue;
                err.store(errno);
                break;
            }
            if (fds[1].revents & POLLIN) {
                uint64_t tmp;
                ssize_t n = read(evfd, &tmp, sizeof(tmp));
                (void)n;
            }
            if (fds[0].revents & POLLIN) {
                // drain fully before honoring HUP — a control frame and the
                // close can arrive in the same poll wake
                bool eof = false;
                while (true) {
                    ssize_t n = recv(fd, chunk.data(), chunk.size(), 0);
                    if (n > 0) {
                        rbuf.append(chunk.data(), size_t(n));
                        continue;
                    }
                    if (n == 0) eof = true;
                    else if (errno != EAGAIN && errno != EWOULDBLOCK)
                        err.store(errno);
                    break;
                }
                parse_control();
                if (eof || err.load() != 0) {
                    ctrl.fetch_or(CTRL_PEER_CLOSED);
                    break;
                }
            } else if (fds[0].revents & (POLLERR | POLLHUP | POLLNVAL)) {
                ctrl.fetch_or(CTRL_PEER_CLOSED);
                if (err.load() == 0) err.store(EPIPE);
                break;
            }
            if (have_data && (fds[0].revents & POLLOUT)) {
                std::lock_guard<std::mutex> lk(mu);
                while (!queue.empty()) {
                    std::string& front = queue.front();
                    ssize_t n = send(fd, front.data(), front.size(),
                                     MSG_NOSIGNAL);
                    if (n < 0) {
                        if (errno == EAGAIN || errno == EWOULDBLOCK) break;
                        err.store(errno);
                        drained.notify_all();
                        return;
                    }
                    queued_bytes -= size_t(n);
                    if (size_t(n) == front.size()) {
                        queue.pop_front();
                    } else {
                        front.erase(0, size_t(n));
                        break;  // short write → wait for next POLLOUT
                    }
                }
                if (queue.empty()) drained.notify_all();
            }
        }
        {
            std::lock_guard<std::mutex> lk(mu);
            closing = true;
        }
        drained.notify_all();
    }
};

std::string frame_bytes(uint8_t kind, const uint8_t* hdr, int64_t hlen,
                        const uint8_t* data, int64_t dlen) {
    std::string out;
    out.reserve(9 + size_t(hlen) + size_t(dlen));
    out.push_back(char(kind));
    for (int shift = 24; shift >= 0; shift -= 8)
        out.push_back(char((uint64_t(hlen) >> shift) & 0xff));
    for (int shift = 24; shift >= 0; shift -= 8)
        out.push_back(char((uint64_t(dlen) >> shift) & 0xff));
    if (hlen) out.append(reinterpret_cast<const char*>(hdr), size_t(hlen));
    if (dlen) out.append(reinterpret_cast<const char*>(data), size_t(dlen));
    return out;
}

}  // namespace

extern "C" {

// Blocking connect with timeout. Returns a connected non-blocking fd with
// TCP_NODELAY, or -errno on failure.
int dp_connect(const char* host, int port, int timeout_ms) {
    struct addrinfo hints = {};
    hints.ai_family = AF_UNSPEC;
    hints.ai_socktype = SOCK_STREAM;
    struct addrinfo* res = nullptr;
    std::string port_s = std::to_string(port);
    if (getaddrinfo(host, port_s.c_str(), &hints, &res) != 0 || !res)
        return -EHOSTUNREACH;
    int fd = socket(res->ai_family, SOCK_STREAM | SOCK_NONBLOCK, 0);
    if (fd < 0) {
        freeaddrinfo(res);
        return -errno;
    }
    int rc = connect(fd, res->ai_addr, res->ai_addrlen);
    freeaddrinfo(res);
    if (rc < 0 && errno == EINPROGRESS) {
        struct pollfd pfd = {fd, POLLOUT, 0};
        rc = poll(&pfd, 1, timeout_ms);
        if (rc <= 0) {
            close(fd);
            return rc == 0 ? -ETIMEDOUT : -errno;
        }
        int soerr = 0;
        socklen_t len = sizeof(soerr);
        getsockopt(fd, SOL_SOCKET, SO_ERROR, &soerr, &len);
        if (soerr != 0) {
            close(fd);
            return -soerr;
        }
    } else if (rc < 0) {
        int e = errno;
        close(fd);
        return -e;
    }
    int one = 1;
    setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
    return fd;
}

void* dpsend_create(int fd) {
    Sender* s = new Sender();
    s->fd = fd;
    s->evfd = eventfd(0, EFD_NONBLOCK);
    s->th = std::thread([s] { s->run(); });
    return s;
}

// Enqueue one frame. Returns 0, or -1 when the sender is dead (error or
// peer closed) — the frame is dropped.
int dpsend_send(void* p, uint8_t kind, const uint8_t* hdr, int64_t hlen,
                const uint8_t* data, int64_t dlen) {
    Sender* s = static_cast<Sender*>(p);
    if (s->err.load() != 0 || (s->ctrl.load() & CTRL_PEER_CLOSED)) return -1;
    {
        std::lock_guard<std::mutex> lk(s->mu);
        if (s->closing) return -1;
        s->queue.emplace_back(frame_bytes(kind, hdr, hlen, data, dlen));
        s->queued_bytes += s->queue.back().size();
    }
    s->wake();
    return 0;
}

int64_t dpsend_queued_bytes(void* p) {
    Sender* s = static_cast<Sender*>(p);
    std::lock_guard<std::mutex> lk(s->mu);
    return int64_t(s->queued_bytes);
}

// Wait for the queue to drain. 0 = drained, -1 = timeout/error.
int dpsend_flush(void* p, int timeout_ms) {
    Sender* s = static_cast<Sender*>(p);
    std::unique_lock<std::mutex> lk(s->mu);
    bool ok = s->drained.wait_for(
        lk, std::chrono::milliseconds(timeout_ms),
        [s] { return s->queue.empty() || s->err.load() != 0; });
    return (ok && s->err.load() == 0) ? 0 : -1;
}

uint32_t dpsend_ctrl(void* p) { return static_cast<Sender*>(p)->ctrl.load(); }

int dpsend_error(void* p) { return static_cast<Sender*>(p)->err.load(); }

// Force the writer thread to exit even with unsent frames (used before
// close when a flush deadline expired — the peer stopped reading).
void dpsend_abort(void* p) {
    Sender* s = static_cast<Sender*>(p);
    s->err.store(ECANCELED);
    {
        std::lock_guard<std::mutex> lk(s->mu);
        s->closing = true;
        s->queue.clear();
        s->queued_bytes = 0;
    }
    s->wake();
}

void dpsend_close(void* p) {
    Sender* s = static_cast<Sender*>(p);
    {
        std::lock_guard<std::mutex> lk(s->mu);
        s->closing = true;
    }
    s->wake();
    if (s->th.joinable()) s->th.join();
    if (s->fd >= 0) close(s->fd);
    if (s->evfd >= 0) close(s->evfd);
    delete s;
}

}  // extern "C"
